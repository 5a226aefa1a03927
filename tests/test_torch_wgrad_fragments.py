"""A lane-level numpy model of the TF32 conv9_wgrad kernel, against its plain version.

The tensor-core kernel (``sshslie_torch/csrc/conv9_wgrad.cu``,
``wgrad_c64_tf32_kernel``, with the helpers ``xt_offset``, ``xt_desc`` and
``rows_fragment_tf32`` of ``csrc/mma.cuh``) runs only on a card. This model
runs its index math here, formula for formula:

* the slices (one wave of blocks: ``splits_tf32``), the rows of a slice whose
  input row lies in the image, and the (row, segment) items;
* the staging: X pixels of the block's window and dY pixels into 72-float
  rows by cp.async chunks (zero outside the image), and the conversion of X,
  in the parts the taps take, into the four phase copies of X^T (K-major
  without swizzle: core matrices of 8 channels x 4 pixels);
* wgmma's reads of B through each tap's descriptor (its phase copy, its start
  4 pixels a step, 256 bytes a k step, the leading and stride offsets);
* the A fragments of every warp and lane (dY^T, the same for every tap),
  rounded to TF32 as they load, assembled into the m16n8k8 A layout;
* the chain cut (fresh accumulators a tap and segment, added to the running
  sums in float32), the warpgroups' taps and which of them they store, the
  accumulator layout of the epilogue, and the sum of the partials in slice
  order.

Every shared-memory access pattern of the model is also checked to be free of
bank conflicts. The model is held against ``conv9_wgrad_plain(...,
tf32=True)`` within 1e-5 of the largest |dW| (float32 sums in another order),
at k = 3, 9 and 13, with W not a multiple of 64 and rows in the padding.
"""

import numpy as np
import pytest
import torch

from sshslie_torch.ops import conv9

C = 64
SEG = 64        # kSegT
WGS = 2         # kWgsT
ROW = 72        # kRowT
LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3


def tile(k):
    """Tf32WTile<K>: (groups, taps of warpgroups 0 and 1, X rows a segment,
    pixels of a phase copy)."""
    groups = 1 if k <= 9 else 2
    split = groups == 1 and k >= 5
    taps = -(-k // (WGS * groups))
    t0, t1 = ((k + 1) // 2, k // 2) if split else (taps, taps)
    return groups, (t0, t1), SEG + t0 + t1 - 1, SEG + 4 * ((t0 + t1 - 1) // 4)


def first_tap(k, u):
    """tf32_first_tap<K>(u)."""
    groups, (t0, t1), _, _ = tile(k)
    if groups == 1 and k >= 5:
        return u * t0
    return min(u * t0, k - t0)


def first_stored(k, u):
    """tf32_first_stored<K>(u)."""
    return u * tile(k)[1][0]


def splits_tf32(b, h, k, sms):
    """splits_tf32<K> with one resident block an SM."""
    groups = tile(k)[0]
    return int(max(1, min(sms // (k * groups), b * h)))


def tf32(a):
    """cvt.rna.tf32.f32 on finite float32: the magnitude + 0x1000, low 13 bits cleared."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    mag = bits & np.uint32(0x7FFFFFFF)
    out = ((mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) | (bits & np.uint32(0x80000000))
    return out.view(np.float32)


def xt_offset(ci, j, sbo):
    """mma.cuh::xt_offset, bytes."""
    ci, j = np.asarray(ci), np.asarray(j)
    return (ci >> 3) * sbo + (j >> 2) * 128 + (ci & 7) * 16 + (j & 3) * 4


def assert_banks(word_addrs, width=1):
    """One warp-wide access of ``width`` words a lane: each phase of 32 / width
    lanes touches every bank at most once."""
    word_addrs = np.asarray(word_addrs).reshape(-1)
    per = 32 // width
    for ph in range(width):
        lanes = word_addrs[ph * per:(ph + 1) * per]
        banks = ((lanes[:, None] + np.arange(width)) % 32).reshape(-1)
        assert len(set(banks.tolist())) == len(banks), "bank conflict"


def descriptor_b(xt_words, start, sbo):
    """B (8 k x 64 n) of one k step: wgmma's reads through xt_desc(start, sbo),
    K-major without swizzle: core matrices of 8 rows (n) x 16 bytes, the next
    4 k at the leading offset (128 bytes), the next 8 n at the stride offset."""
    n = np.arange(64)[None, :]
    kk = np.arange(8)[:, None]
    addr = start + (n >> 3) * sbo + (kk >> 2) * 128 + (n & 7) * 16 + (kk & 3) * 4
    for core in range(8):                     # each core matrix: 128 contiguous bytes
        blk = addr[(core & 1) * 4:(core & 1) * 4 + 4, (core >> 1) * 8:(core >> 1) * 8 + 8]
        assert sorted(blk.reshape(-1).tolist()) == list(range(blk.min(), blk.min() + 128, 4))
    return xt_words[addr // 4]


def a_matrix(rows_words, aoff_of_warp, px0):
    """The warpgroup's A (64 channels x 8 pixels) of one k step:
    rows_fragment_tf32 of each warp's lanes (pointer rows + aoff, aoff
    holding the lane's q and channel), placed by the m16n8k8 A layout."""
    a = np.zeros((64, 8), np.float32)
    for wq in range(4):
        r = aoff_of_warp[wq] + px0 * ROW
        for reg, off in enumerate((0, 8, 4 * ROW, 4 * ROW + 8)):
            assert_banks(r + off)
            rows = 16 * wq + G + 8 * (reg & 1)
            cols = Q + 4 * (reg >> 1)
            a[rows, cols] = tf32(rows_words[r + off])
    return a


def land(src_rows, first, count, width):
    """cp.async of pixels first .. first + count - 1 of one image row
    (width pixels, 64 channels) into rows of 72 floats, zero outside: thread
    tid of warpgroup 0 copies chunk tid % 16 of pixels tid / 16 + 8 n."""
    out = np.full(count * ROW, np.nan, np.float32)
    for tid in range(128):
        ch, p0 = tid & 15, tid >> 4
        for n in range(-(-count // 8)):
            p = p0 + 8 * n
            if p >= count:
                continue
            gw = first + p
            inside = 0 <= gw < width
            out[p * ROW + ch * 4:p * ROW + ch * 4 + 4] = src_rows[gw, ch * 4:ch * 4 + 4] if inside else 0
    return out


def convert_x(raw, k):
    """convert_x over all its parts: the phase copies of X^T, as words; also
    checks that the taps' parts cover every task once and the banks. A warp
    of warpgroup 1 takes a task, (core matrix column J, 32 channels): 7
    pixels of a lane's channel loaded, 4 of them stored into each copy, 16
    bytes."""
    _, (_, t1), xrows, pix = tile(k)
    sbo = pix * 32
    xt = np.full(4 * 8 * sbo // 4, np.nan, np.float32)
    tasks = pix // 4 * 2
    parts = t1                                # a part at each of warpgroup 1's taps
    per = -(-tasks // parts)
    seen = []
    for part in range(parts):
        end = min(tasks, (part + 1) * per)
        for warp in range(4):                 # warpgroup 1's warps
            for task in range(part * per + warp, end, 4):
                seen.append(task)
                cj, ci0 = task >> 1, (task & 1) * 32
                rows = [min(4 * cj + e, xrows - 1) for e in range(7)]
                loads = [r * ROW + ci0 + LANE for r in rows]
                for ld in loads:
                    assert_banks(ld)
                v = [tf32(raw[ld]) for ld in loads]
                ci = ci0 + LANE
                base = ((ci >> 3) * sbo + cj * 128 + (LANE & 7) * 16) // 4
                for c in range(4):
                    wa = base + c * 8 * sbo // 4
                    assert_banks(wa, width=4)
                    assert np.all(wa * 4 == c * 8 * sbo + xt_offset(ci, 4 * cj, sbo))
                    for e in range(4):
                        xt[wa + e] = v[c + e]
    assert sorted(seen) == list(range(tasks))
    return xt, sbo


def block(x, dy, k, s, kh, z, splits):
    """One block (slice s, kernel row kh, tap group z): its partials, (k, 64, 64)
    for the taps it stores (NaN elsewhere)."""
    b_, h_, w_, _ = x.shape
    groups, taps, xrows, pix = tile(k)
    p = (k - 1) // 2
    rows = b_ * h_
    r0, r1 = rows * s // splits, rows * (s + 1) // splits
    nseg = -(-w_ // SEG)
    xf = x.reshape(rows, w_, C)
    dyf = dy.reshape(rows, w_, C)

    def valid(r):
        return 0 <= r % h_ + kh - p < h_

    items = [(r, seg) for r in range(r0, r1) if valid(r) for seg in range(nseg)]
    kwb = first_tap(k, z * WGS)
    acc = {(wg, t): np.zeros((64, 64), np.float32) for wg in range(WGS) for t in range(taps[wg])}
    for r, seg in items:
        raw = land(xf[r + kh - p], seg * SEG - p + kwb, xrows, w_)
        ds = land(dyf[r], seg * SEG, SEG, w_)
        xt, sbo = convert_x(raw, k)
        aoff = [Q * ROW + 16 * wq + G for wq in range(4)]
        a = [a_matrix(ds, aoff, 8 * ks) for ks in range(8)]      # dY^T, every tap's
        for wg in range(WGS):
            kw0 = first_tap(k, z * WGS + wg)
            for t in range(taps[wg]):
                rr = kw0 - kwb + t                                 # copy rr % 4, pixel 4 (rr // 4)
                start = (rr & 3) * 8 * sbo + (rr >> 2) * 128
                fresh = np.zeros((64, 64), np.float32)
                for ks in range(8):
                    bk = descriptor_b(xt, start + ks * 256, sbo)
                    assert not np.isnan(bk).any(), "B reads a pixel the copies do not hold"
                    prod = a[ks].astype(np.float64) @ bk.astype(np.float64)
                    fresh = (prod if ks == 0 else fresh + prod).astype(np.float32)
                acc[(wg, t)] = acc[(wg, t)] + fresh
    # Epilogue: acc[t][i] is co 16 wq + g + 8 ((i >> 1) & 1), ci 8 (i >> 2) + 2 q + (i & 1).
    out = np.full((k, 64, 64), np.nan, np.float32)
    i = np.arange(32)
    for wg in range(WGS):
        u = z * WGS + wg
        kw0 = first_tap(k, u)
        for t in range(taps[wg]):
            kw = kw0 + t
            if kw < first_stored(k, u):
                continue
            seen = np.zeros((64, 64), int)
            for wq in range(4):
                co = 16 * wq + G[:, None] + 8 * ((i[None, :] >> 1) & 1)
                ci = 8 * (i[None, :] >> 2) + 2 * Q[:, None] + (i[None, :] & 1)
                assert np.isnan(out[kw, ci, co]).all(), "a tap stored twice"
                out[kw, ci, co] = acc[(wg, t)][co, ci]
                seen[ci, co] += 1
            assert np.all(seen == 1)
    return out


def model(x, dy, k, sms):
    """The launch: the slices' partials, then wgrad_reduce_kernel's sum in slice order."""
    b_, h_, _, _ = x.shape
    groups = tile(k)[0]
    splits = splits_tf32(b_, h_, k, sms)
    part = np.full((splits, k, k, 64, 64), np.nan, np.float32)
    for s in range(splits):
        for kh in range(k):
            for z in range(groups):
                got = block(x, dy, k, s, kh, z, splits)
                stored = ~np.isnan(got[:, 0, 0])
                assert np.isnan(part[s, kh, stored]).all()
                part[s, kh, stored] = got[stored]
    assert not np.isnan(part).any(), "a tap of a slice is never stored"
    dw = part[0].copy()
    for s in range(1, splits):
        dw = dw + part[s]
    return dw, splits


@pytest.mark.parametrize("k,shape,sms", [
    (3, (1, 5, 70, 64), 132),   # two segments, the second of 6 pixels; a row a slice
    (9, (2, 6, 40, 64), 18),    # W < 64, H < k: most rows of a kernel row in the padding; 2 slices
    (13, (1, 4, 67, 64), 132),  # two tap groups; rows in the padding; a segment of 3 pixels
])
def test_model_matches_plain_tf32(k, shape, sms):
    rng = np.random.default_rng(7 + k)
    x = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    got, splits = model(x, dy, k, sms)
    want = conv9.conv9_wgrad_plain(torch.from_numpy(x), torch.from_numpy(dy), k, tf32=True).numpy()
    assert splits == (shape[0] * shape[1] if sms == 132 else 2)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"k{k} {shape}: max|d| {err:.3e} > 1e-5 x {scale:.3e}"
    # Truncating the operands instead of rounding them shows at this size.
    trunc = conv9.conv9_wgrad_plain(
        torch.from_numpy(x.view(np.uint32) & np.uint32(0xFFFFE000)).view(torch.float32),
        torch.from_numpy(dy.view(np.uint32) & np.uint32(0xFFFFE000)).view(torch.float32), k).numpy()
    assert float(np.abs(trunc - want).max()) > 1e-5 * scale


def test_tap_assignment_covers_each_tap_once():
    """Every tap of a kernel row is stored by exactly one warpgroup, and each
    warpgroup's taps lie inside its block's staged X window and phase copies."""
    for k in conv9.KERNEL_SIZES:
        groups, taps, xrows, pix = tile(k)
        owners = []
        for z in range(groups):
            kwb = first_tap(k, z * WGS)
            for wg in range(WGS):
                u = z * WGS + wg
                kw0 = first_tap(k, u)
                assert 0 <= kw0 and kw0 + taps[wg] <= k
                last = kw0 - kwb + taps[wg] - 1              # the window's last tap
                assert last + 63 < xrows and (last >> 2) * 4 + 63 < pix
                owners += [kw for kw in range(kw0, kw0 + taps[wg]) if kw >= first_stored(k, u)]
        assert sorted(owners) == list(range(k)), k
