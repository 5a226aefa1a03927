"""A lane-level numpy model of the bfloat16 flash kernel, against JAX on the CPU.

The tensor-core kernel (``sshslie_torch/csrc/flash_attn.cu``,
``flash_tc_kernel``) runs only on a card. This model runs its index math
here: the padded shared-memory rows its cp.async copies write, ``ldmatrix``
(plain and ``.trans``) and ``mma.sync.m16n8k16`` with the fragment layouts of
the PTX ISA's tables, and the kernel's own per-lane formulas: the ldmatrix row
addresses, the repack of the S accumulators into P's A fragment, the quad
reductions and the hi + lo split of p into two accumulator sets. The model is then held against
``sshslie_tpu.ops.attention.sdpa_chunked`` on the operands widened to
float32 (the Pallas kernel's float32 p) within one bfloat16 step of max|o|,
and against the port's plain ``sdpa_chunked`` on the bfloat16 operands (p
rounded to bfloat16, which moves o by at most 2^-9 of max|v|) within that
plus 2^-9 of max|v|. ex2.approx is modelled as
an exact exp2: its 2-ulp error is far below one bfloat16 step. Every ldmatrix
is also checked to be free of bank conflicts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sshslie_tpu.ops import attention as ja
from sshslie_torch.ops import attention as ta

NEG_INF = np.float32(-1e30)
BF16_STEP = 2.0 ** -7
LANE = np.arange(32)
G, T4 = LANE >> 2, LANE & 3          # mma: groupID, thread in group
QUAD = [LANE ^ 1, LANE ^ 2]          # __shfl_xor_sync partners


def to_bf16(x):
    """float32 -> bfloat16 bits, round to nearest even."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def from_bf16(b):
    return (np.asarray(b).astype(np.uint32) << 16).view(np.float32)


def cvt_bf16x2(lo, hi):
    return to_bf16(lo).astype(np.uint32) | (to_bf16(hi).astype(np.uint32) << 16)


def halves(r):
    return from_bf16(r & 0xFFFF), from_bf16(r >> 16)


def ldmatrix_x4(smem, addrs, trans=False):
    """Lane l gives the row address of row l % 8 of matrix l // 8; register i
    of lane l gets matrix i's row l // 4, elements 2 (l % 4) and + 1 (with
    .trans: column l // 4, rows 2 (l % 4) and + 1)."""
    assert np.all(addrs % 16 == 0)
    for mat in addrs.reshape(4, 8):
        assert len(set((mat // 16) % 8)) == 8, "bank conflict"
    rows = np.stack([smem[a:a + 16].view(np.uint16) for a in addrs]).reshape(4, 8, 8)
    lo, hi = ((rows[:, 2 * T4, G], rows[:, 2 * T4 + 1, G]) if trans
              else (rows[:, G, 2 * T4], rows[:, G, 2 * T4 + 1]))
    return (lo.astype(np.uint32) | (hi.astype(np.uint32) << 16)).T


def mma(d, a, b0, b1):
    """d (32, 4) float32 += A (16 x 16) B (16 x 8): PTX m16n8k16 .bf16 layouts."""
    A = np.zeros((16, 16), np.float32)
    for r, (row, col) in enumerate(((G, 2 * T4), (G + 8, 2 * T4), (G, 2 * T4 + 8), (G + 8, 2 * T4 + 8))):
        A[row, col], A[row, col + 1] = halves(a[:, r])
    B = np.zeros((16, 8), np.float32)
    for r, b in enumerate((b0, b1)):
        B[2 * T4 + 8 * r, G], B[2 * T4 + 8 * r + 1, G] = halves(b)
    C = np.zeros((16, 8), np.float32)
    C[G, 2 * T4], C[G, 2 * T4 + 1], C[G + 8, 2 * T4], C[G + 8, 2 * T4 + 1] = d.T
    D = (A.astype(np.float64) @ B + C).astype(np.float32)
    return np.stack([D[G, 2 * T4], D[G, 2 * T4 + 1], D[G + 8, 2 * T4], D[G + 8, 2 * T4 + 1]], 1)


class Tiles:
    """TcTiles of flash_attn.cu."""

    def __init__(self, d, bk, stages):
        self.D, self.BK, self.STAGES = d, bk, stages
        self.kThreads, self.BQ, self.NT = 128, 64, bk // 8
        self.RB = 2 * d + 16
        self.kTileBytes = bk * self.RB
        self.kStageBytes = 2 * self.kTileBytes


def tc_qk(T, smem, ka, qa, key0, S):
    NT, RB = T.NT, T.RB
    s = np.zeros((NT, 32, 4), np.float32)
    for kk in range(T.D // 16):
        for jj in range(NT // 2):
            b = ldmatrix_x4(smem, ka + jj * 16 * RB + kk * 32)
            s[2 * jj] = mma(s[2 * jj], qa[kk], b[:, 0], b[:, 1])
            s[2 * jj + 1] = mma(s[2 * jj + 1], qa[kk], b[:, 2], b[:, 3])
    if key0 + T.BK > S:
        for j in range(NT):
            for e in range(4):
                s[j, key0 + 8 * j + 2 * T4 + (e & 1) >= S, e] = NEG_INF
    return s


def tc_stage(T, smem, ka, va, key0, S, c, qa, acc, m, l):
    """tc_stage of flash_attn.cu: Q K^T, the online-softmax update (one
    correction a row), P V with p as a bfloat16 pair hi + lo."""
    NT, RB = T.NT, T.RB
    s = tc_qk(T, smem, ka, qa, key0, S)
    mc = np.zeros((32, 2), np.float32)
    for i in range(2):
        mn = np.maximum(m[:, i], s[:, :, 2 * i:2 * i + 2].max(axis=(0, 2)))
        for partner in QUAD:
            mn = np.maximum(mn, mn[partner])
        corr = np.exp2((m[:, i] - mn) * c).astype(np.float32)
        m[:, i], mc[:, i] = mn, mn * c
        l[:, i] *= corr
        acc[:, :, :, 2 * i:2 * i + 2] *= corr[None, None, :, None]
    # fmaf(s, c, -m c): s c is exact in float64.
    s = np.exp2((s.astype(np.float64) * c - np.repeat(mc, 2, axis=1)).astype(np.float32))
    for j in range(NT):
        for e in range(4):
            l[:, e >> 1] += s[j, :, e]
    for kk in range(NT // 2):
        pairs = [(s[2 * kk, :, 0], s[2 * kk, :, 1]), (s[2 * kk, :, 2], s[2 * kk, :, 3]),
                 (s[2 * kk + 1, :, 0], s[2 * kk + 1, :, 1]), (s[2 * kk + 1, :, 2], s[2 * kk + 1, :, 3])]
        hi = np.stack([cvt_bf16x2(x0, x1) for x0, x1 in pairs], 1)
        lo = np.stack([cvt_bf16x2(x0 - halves(r)[0], x1 - halves(r)[1])
                       for (x0, x1), r in zip(pairs, hi.T)], 1)
        for n2 in range(T.D // 16):
            b = ldmatrix_x4(smem, va + kk * 16 * RB + n2 * 32, trans=True)
            for h, a in enumerate((hi, lo)):
                acc[h, 2 * n2] = mma(acc[h, 2 * n2], a, b[:, 0], b[:, 1])
                acc[h, 2 * n2 + 1] = mma(acc[h, 2 * n2 + 1], a, b[:, 2], b[:, 3])


def flash_tc_model(q, k, v, T):
    """flash_tc_kernel on (BH, S, D) bfloat16 bits -> bfloat16 bits."""
    BH, S, D = q.shape
    c = np.float32(np.log2(np.e) / np.sqrt(D))
    out_bits = np.zeros_like(q)
    mi, r8 = LANE >> 3, LANE & 7
    ntiles = -(-S // T.BK)
    chunks = np.arange(T.BK * D // 8)            # every thread's copies of a tile
    for bh in range(BH):
        kb, vb = k[bh].reshape(-1), v[bh].reshape(-1)
        for blk in range(-(-S // T.BQ)):
            smem = np.zeros(T.STAGES * T.kStageBytes, np.uint8)
            warps = []
            for warp in range(4):
                row0 = blk * T.BQ + warp * 16
                qa = np.zeros((D // 16, 32, 4), np.uint32)
                for kk in range(D // 16):
                    for r, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                        row = row0 + G + dr
                        ok = row < S
                        col = 16 * kk + 2 * T4 + dc
                        lo_ = np.where(ok, q[bh, np.minimum(row, S - 1), col], 0)
                        hi_ = np.where(ok, q[bh, np.minimum(row, S - 1), col + 1], 0)
                        qa[kk, :, r] = lo_.astype(np.uint32) | (hi_.astype(np.uint32) << 16)
                warps.append(dict(row0=row0, qa=qa, acc=np.zeros((2, D // 8, 32, 4), np.float32),
                                  m=np.full((32, 2), NEG_INF, np.float32),
                                  l=np.zeros((32, 2), np.float32)))
            ka = ((mi >> 1) * 8 + r8) * T.RB + (mi & 1) * 16
            va = T.kTileBytes + ((mi & 1) * 8 + r8) * T.RB + (mi >> 1) * 16
            for t in range(ntiles):
                st = (t % T.STAGES) * T.kStageBytes
                r = chunks // (D // 8)
                dst = st + r * T.RB + (chunks % (D // 8)) * 16
                for src, base in ((kb, 0), (vb, T.kTileBytes)):
                    for i, (rr, dd) in enumerate(zip(r, dst)):
                        data = (src[t * T.BK * D + 8 * i:t * T.BK * D + 8 * i + 8]
                                if t * T.BK + rr < S else np.zeros(8, np.uint16))
                        smem[base + dd:base + dd + 16] = data.view(np.uint8)
                for w in warps:
                    tc_stage(T, smem, st + ka, st + va, t * T.BK, S, c, w["qa"],
                             w["acc"], w["m"], w["l"])
            for w in warps:
                for partner in QUAD:
                    w["l"] = w["l"] + w["l"][partner]
                for i in range(2):
                    row = w["row0"] + G + 8 * i
                    ok = row < S
                    for n in range(D // 8):
                        pair = cvt_bf16x2((w["acc"][0, n, :, 2 * i] + w["acc"][1, n, :, 2 * i]) / w["l"][:, i],
                                          (w["acc"][0, n, :, 2 * i + 1] + w["acc"][1, n, :, 2 * i + 1])
                                          / w["l"][:, i])
                        out_bits[bh, row[ok], 8 * n + 2 * T4[ok]] = pair[ok] & 0xFFFF
                        out_bits[bh, row[ok], 8 * n + 2 * T4[ok] + 1] = pair[ok] >> 16
    return out_bits


# The kernel's keys and stages per head dim (sshslie_flash_attn_bf16).
KERNEL_TILES = {16: (128, 3), 32: (64, 3), 64: (64, 2)}


@pytest.mark.parametrize("shape,growing", [((1, 1, 1, 16), False), ((1, 1, 3, 16), False),
                                           ((1, 2, 70, 16), False), ((1, 1, 300, 16), False),
                                           ((1, 1, 300, 16), True), ((1, 1, 100, 32), False),
                                           ((2, 1, 140, 64), True)])
def test_fragment_model_matches_jax_and_the_plain_path(shape, growing):
    # growing: keys grow in scale along S, so the running max grows stage
    # after stage and every stage rescales l and O.
    b, h, s, d = shape
    rng = np.random.default_rng(s * 7 + d)
    scale = np.linspace(0.3, 4.0, s)[:, None] if growing else 1.0
    q, k, v = (to_bf16(rng.standard_normal((b * h, s, d)) * sc) for sc in (2.0, 2.0 * scale, 1.0))
    got = from_bf16(flash_tc_model(q, k, v, Tiles(d, *KERNEL_TILES[d]))).reshape(shape)
    qf, kf, vf = (from_bf16(x).reshape(shape) for x in (q, k, v))
    want32 = np.asarray(ja.sdpa_chunked(*(jnp.asarray(x) for x in (qf, kf, vf))))
    err = float(np.abs(got - want32).max())
    assert err <= BF16_STEP * float(np.abs(want32).max()), err
    plain = ta.sdpa_chunked(*(torch.from_numpy(x).to(torch.bfloat16) for x in (qf, kf, vf))).float().numpy()
    err = float(np.abs(got - plain).max())
    assert err <= BF16_STEP * float(np.abs(plain).max()) + 2.0 ** -9 * float(np.abs(vf).max()), err
