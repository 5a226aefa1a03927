// Blockwise softmax(Q K^T / sqrt(d)) V with an online softmax on an H100: a
// float32 kernel on the CUDA cores (flash_fwd_kernel, this note), and a
// bfloat16 kernel on the tensor cores (flash_tc_kernel, the note after it).
//
// Replaces: sshslie_tpu/ops/attention.py::flash_attention (Pallas kernel
// _flash_kernel). Same function over contiguous (B, H, S, D) tensors: the
// running max m, running sum l and the output accumulator stay in float32,
// and keys at or past S are masked with -1e30, so an S that is not a multiple
// of the tile needs no padding copy. The head dim stays what it is (16 for the
// TransformerBlock): the TPU kernel's padding of d to 128 lanes is an MXU rule
// and is not carried over.
//
// What bounds it: at (1, 4, 4096, 16) the two products are 4*B*H*S^2*D =
// 4.3e9 FLOP, 64 us at the 67 TFLOP/s of float32 FMA outside the tensor cores
// (TF32 is off for parity); the 6.7e7 exponentials take 16 us on the SFU's own
// pipe, and the 4.2 MB of q, k, v and o 1.3 us. So the FMA pipes set the
// floor. Next to them, shared memory: a warp's LDS.128 hands 512 bytes to its
// registers, 4 clocks of an SM's 128 bytes a clock whatever the broadcast, so
// every float of K or V a thread reads must feed 4 FMAs to keep pace with the
// FMA pipes' 128 a clock.
//
// Design, per block of WARPS warps over (one b*h, BQ queries):
// - Register blocking over queries. A thread owns TQ query rows: TQ * D = 64
//   floats of q, pre-scaled by log2(e)/sqrt(d) so that the exponential is
//   exp2, and 64 floats of accumulator. Every K or V float it reads from
//   shared memory feeds TQ FMAs: 4 at d = 16, which puts the loads at parity
//   with the FMAs; more rows do not fit in 255 registers.
// - Key split across lanes. KL consecutive lanes share a row group; lane kl
//   scores keys kl, kl + KL, ... of each tile with its own (m, l, acc). The
//   other row groups of the warp read the same keys (a broadcast), and rows
//   in shared memory are padded by 4 floats, so the KL float4 of one load fall
//   in distinct banks. At the end the KL partial states of a row merge
//   through warp shuffles in a fixed order.
// - K/V tiles of BK keys stream global -> shared by 16-byte cp.async
//   (zero-filled past S) into two stages: tile t + 1 loads while tile t is
//   scored, with one __syncthreads a tile.
// - The softmax runs in chunks of NC keys a lane: one max and one rescale
//   of l and acc a chunk, 64 FMUL against the chunk's 1,024 FMA at d = 16.
// - No float atomics: every output value is written by one lane, and every
//   sum runs in a fixed order, so two calls give the same bits.
// At d = 16 the kernel runs at ~55% of the FMA peak (PERF.md, with the tile
// numbers tried and the instruction mix of a chunk). The tile numbers are
// fixed per head dim at the end of the namespace below.
// flash_fwd_kernel and flash_entry keep the element type E and the bfloat16
// branches they had when the bfloat16 entry was this kernel on widened
// operands, so the float32 code is the same text as then; only E = float is
// instantiated now.
//
// bfloat16 entry (sshslie_flash_attn_bf16): a kernel of its own on the
// tensor cores (flash_tc_kernel), the same function on bfloat16 q, k and v:
// float32 logits, m, l and accumulator, the -1e30 mask past S without a
// padding copy, the output rounded to bfloat16 once.
//
// What bounds it: at (1, 4, 4096, 16) the products take 4.3 us at wgmma's
// 989 TFLOP/s, 6.6 us at the ~646 TFLOP/s mma.sync reaches (tools/tc_probe.py);
// the 6.7e7 exponentials take 16.0 us on the SFUs (16 a clock per SM). So the
// SFU sets the floor of the work, and mma.sync is fast enough. Next come the
// softmax's own instructions a logit on the FMA and ALU pipes: the FFMA that
// folds the scale, the max, the sum, the conversions to bfloat16. Measured
// (PERF.md, the flash timed variants) neither is what holds it: the K/V stream
// from L2 (every 64-query block reads its head's K and V; ~2.3 TB/s) and the
// stage's chain of dependent steps with 2 warps a scheduler each take about
// as long as the whole kernel.
//
// p is carried as a bfloat16 pair hi + lo, two P V products: ~16 bits of p,
// the Pallas kernel's float32 p to ~2^-17, where one bfloat16 p (JAX's
// sdpa_chunked, the port's plain version) would move o by up to 2^-9 of
// max|v|. The pair cost 18% over one bfloat16 p at (1, 4, 4096, 16), under
// the 20% the float32-p semantics were allowed.
//
// Design, per block of 4 warps over (one b*h, 64 queries):
// - A warp owns 16 query rows, the M of mma.sync m16n8k16: at
//   (1, 4, 4096, 16) that is 1,024 warps, ~2 on each SM sub-partition.
// - K/V tiles of BK keys go to shared memory as bfloat16 by 16-byte cp.async
//   (zero-filled past S) into STAGES stages, key-major rows padded to an odd
//   number of 16-byte chunks, so every ldmatrix is free of bank conflicts.
// - S = Q K^T: q stays unscaled bfloat16 A fragments in registers, loaded
//   once; K's B fragments by ldmatrix; D / 16 k steps.
// - Softmax in registers, in the accumulator layout: the row max on the raw
//   logits (a tree over the lane's keys, then two shuffles over the quad),
//   p = ex2(s c - m c) as one FFMA and one ex2.approx (c = log2(e) /
//   sqrt(d), the qk_scale_log2 argument), l summed from the float32 p, one
//   correction ex2 a row and stage. Only the ragged last stage takes the
//   masked branch.
// - O += P V: the S accumulators, repacked in registers as A fragments
//   (cvt.rn.bf16x2.f32), no trip through shared memory; V's B fragments by
//   ldmatrix.trans.
// - No atomics, every sum in a fixed order: repeats are bit-identical.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

template <int TQ_, int KL_, int BK_, int NC_, int WARPS_>
struct Tiles {
  static constexpr int TQ = TQ_;        // query rows a thread owns
  static constexpr int KL = KL_;        // lanes that split a row group's keys
  static constexpr int BK = BK_;        // keys per shared-memory stage
  static constexpr int NC = NC_;        // keys a lane takes per softmax chunk
  static constexpr int WARPS = WARPS_;  // warps per block
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kGroups = 32 / KL;            // row groups per warp
  static constexpr int BQ = WARPS * kGroups * TQ;    // queries per block
  static constexpr int NK = BK / KL;                 // keys a lane takes per tile
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// One chunk of NC keys a lane: scores, online-softmax update, P V.
// kt, vt point at this lane's first key of the chunk; keys are KL rows apart.
template <int D, class T, bool kMasked>
__device__ __forceinline__ void chunk(const float* kt, const float* vt, int key0, int S,
                                      const float (&qr)[T::TQ][D], float (&acc)[T::TQ][D],
                                      float (&m)[T::TQ], float (&l)[T::TQ]) {
  constexpr int DP = D + 4;
  constexpr int TQ = T::TQ;
  constexpr int NC = T::NC;
  float s[TQ][NC];
#pragma unroll
  for (int jj = 0; jj < NC; ++jj) {
    const float* kr = kt + jj * T::KL * DP;
#pragma unroll
    for (int i = 0; i < TQ; ++i) s[i][jj] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        s[i][jj] = fmaf(qr[i][d], kk.x, s[i][jj]);
        s[i][jj] = fmaf(qr[i][d + 1], kk.y, s[i][jj]);
        s[i][jj] = fmaf(qr[i][d + 2], kk.z, s[i][jj]);
        s[i][jj] = fmaf(qr[i][d + 3], kk.w, s[i][jj]);
      }
    }
    if (kMasked && key0 + jj * T::KL >= S) {
#pragma unroll
      for (int i = 0; i < TQ; ++i) s[i][jj] = kNegInf;
    }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    float m_new = m[i];
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) m_new = fmaxf(m_new, s[i][jj]);
    const float corr = fast_exp2(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[i][d] *= corr;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      s[i][jj] = fast_exp2(s[i][jj] - m_new);
      l[i] += s[i][jj];
    }
  }

#pragma unroll
  for (int jj = 0; jj < NC; ++jj) {
    const float* vr = vt + jj * T::KL * DP;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        acc[i][d] = fmaf(s[i][jj], vv.x, acc[i][d]);
        acc[i][d + 1] = fmaf(s[i][jj], vv.y, acc[i][d + 1]);
        acc[i][d + 2] = fmaf(s[i][jj], vv.z, acc[i][d + 2]);
        acc[i][d + 3] = fmaf(s[i][jj], vv.w, acc[i][d + 3]);
      }
    }
  }
}

template <int D, class T, class E>
__global__ void __launch_bounds__(T::kThreads)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, E* __restrict__ o, int S,
                 float qk_scale_log2) {
  constexpr int DP = D + 4;  // padded row, a multiple of 4 floats
  constexpr int TQ = T::TQ;
  constexpr int KL = T::KL;
  constexpr int BK = T::BK;
  constexpr int kPer = TQ * D / KL;  // outputs each lane of a row group writes
  static_assert(32 % KL == 0 && BK % KL == 0 && T::NK % T::NC == 0, "tile shape");
  static_assert(D % 4 == 0 && kPer % 4 == 0, "float4 rows");
  __shared__ __align__(16) float ks[2][BK * DP];
  __shared__ __align__(16) float vs[2][BK * DP];

  const int lane = threadIdx.x & 31;
  const int kl = lane % KL;
  const int group = (threadIdx.x >> 5) * T::kGroups + lane / KL;
  const int row0 = blockIdx.x * T::BQ + group * TQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const E* kb = k + base;
  const E* vb = v + base;

  // A thread's share of a stage: kLoads 4-value copies of K and of V, at the
  // same row offsets and column every tile, zero-filled past S; float32 by
  // cp.async, bfloat16 by a plain load widened to float32.
  constexpr int kRowStep = T::kThreads / (D / 4);  // rows between a thread's copies
  constexpr int kLoads = BK / kRowStep;
  static_assert(T::kThreads % (D / 4) == 0 && BK % kRowStep == 0, "whole copies a thread");
  const int lrow = threadIdx.x / (D / 4);
  const int lcol = (threadIdx.x % (D / 4)) * 4;
  auto load_tile = [&](int t, int st) {
    const size_t g = (static_cast<size_t>(t) * BK + lrow) * D + lcol;
    float* kd = ks[st] + lrow * DP + lcol;
    float* vd = vs[st] + lrow * DP + lcol;
    if constexpr (std::is_same<E, float>::value) {
#pragma unroll
      for (int n = 0; n < kLoads; ++n) {
        const bool in = t * BK + lrow + n * kRowStep < S;
        const size_t off = in ? g + n * kRowStep * D : 0;
        cp_async16(kd + n * kRowStep * DP, kb + off, in ? 16 : 0);
        cp_async16(vd + n * kRowStep * DP, vb + off, in ? 16 : 0);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
#pragma unroll
      for (int n = 0; n < kLoads; ++n) {
        float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 vv = kk;
        if (t * BK + lrow + n * kRowStep < S) {
          kk = load4(kb + g + n * kRowStep * D);
          vv = load4(vb + g + n * kRowStep * D);
        }
        *reinterpret_cast<float4*>(kd + n * kRowStep * DP) = kk;
        *reinterpret_cast<float4*>(vd + n * kRowStep * DP) = vv;
      }
    }
  };

  const int ntiles = (S + BK - 1) / BK;
  load_tile(0, 0);

  float qr[TQ][D];
  float acc[TQ][D];
  float m[TQ];
  float l[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const bool active = row0 + i < S;
    const E* qrow = q + base + static_cast<size_t>(row0 + i) * D;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (active) x = load4(qrow + d);
      qr[i][d] = x.x * qk_scale_log2;
      qr[i][d + 1] = x.y * qk_scale_log2;
      qr[i][d + 2] = x.z * qk_scale_log2;
      qr[i][d + 3] = x.w * qk_scale_log2;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) acc[i][d] = 0.f;
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    // Tile t has landed for every thread, and tile t - 1 is consumed, so its
    // stage may take tile t + 1.
    if constexpr (std::is_same<E, float>::value) asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
    const float* kt = ks[t & 1] + kl * DP;
    const float* vt = vs[t & 1] + kl * DP;
    const int k0 = t * BK + kl;
    if (t * BK + BK <= S) {
#pragma unroll 1
      for (int c = 0; c < T::NK; c += T::NC)
        chunk<D, T, false>(kt + c * KL * DP, vt + c * KL * DP, k0 + c * KL, S, qr, acc, m, l);
    } else {
#pragma unroll 1
      for (int c = 0; c < T::NK; c += T::NC)
        chunk<D, T, true>(kt + c * KL * DP, vt + c * KL * DP, k0 + c * KL, S, qr, acc, m, l);
    }
  }

  // Merge the KL partial softmax states of each row (lanes of one row group
  // are consecutive), then each lane writes kPer of the row group's outputs.
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    float m_row = m[i];
#pragma unroll
    for (int off = 1; off < KL; off <<= 1)
      m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, off));
    const float f = fast_exp2(m[i] - m_row);
    float li = l[i] * f;
#pragma unroll
    for (int off = 1; off < KL; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    l[i] = li;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a = acc[i][d] * f;
#pragma unroll
      for (int off = 1; off < KL; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[i][d] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    if (row0 + i >= S) continue;
    const float inv_l = 1.f / l[i];
    E* orow = o + base + static_cast<size_t>(row0 + i) * D;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      if ((i * D + d) / kPer != kl) continue;
      store4(orow + d, make_float4(acc[i][d] * inv_l, acc[i][d + 1] * inv_l,
                                   acc[i][d + 2] * inv_l, acc[i][d + 3] * inv_l));
    }
  }
}

template <int D, class T, class E>
int launch(const E* q, const E* k, const E* v, E* o, int BH, int S,
           float qk_scale_log2, cudaStream_t stream) {
  const dim3 grid((S + T::BQ - 1) / T::BQ, BH);
  flash_fwd_kernel<D, T, E><<<grid, T::kThreads, 0, stream>>>(q, k, v, o, S, qk_scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of each head dim: TQ * D = 64 floats of q and of acc a thread.
using TilesD16 = Tiles<4, 8, 128, 8, 4>;
using TilesD32 = Tiles<2, 8, 64, 8, 4>;
using TilesD64 = Tiles<1, 8, 32, 4, 4>;  // 32-key stages: 35 KB of static shared memory

template <class E>
int flash_entry(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
                float qk_scale_log2, void* stream) {
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  E* oe = static_cast<E*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16, TilesD16>(qe, ke, ve, oe, BH, S, qk_scale_log2, s);
    case 32:
      return launch<32, TilesD32>(qe, ke, ve, oe, BH, S, qk_scale_log2, s);
    case 64:
      return launch<64, TilesD64>(qe, ke, ve, oe, BH, S, qk_scale_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bfloat16: mma.sync m16n8k16 on the tensor cores ----

template <int D_, int BK_, int STAGES_>
struct TcTiles {
  static constexpr int D = D_;
  static constexpr int BK = BK_;          // keys per shared-memory stage
  static constexpr int STAGES = STAGES_;  // cp.async stages of K and V
  static constexpr int kThreads = 128;
  static constexpr int BQ = 64;           // 4 warps of 16 queries
  static constexpr int NT = BK / 8;       // n-tiles of S (8 keys each) a warp holds
  // A key's row in shared memory: 2 D bytes padded by 16, an odd number of
  // 16-byte chunks, so the 8 rows of an ldmatrix fall in 8 distinct 16-byte
  // bank groups (rows 48, 80 or 144 bytes apart).
  static constexpr int kRowBytes = 2 * D + 16;
  static constexpr int kTileBytes = BK * kRowBytes;  // K (or V) of one stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static_assert(D % 16 == 0 && BK % 16 == 0, "whole k16 steps");
  static_assert(STAGES * kStageBytes <= 48 * 1024, "static shared memory");
};

// Two floats rounded to a bfloat16 pair, lo in the low half.
__device__ __forceinline__ unsigned cvt_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The residual of a pair after its bfloat16 rounding hi, rounded again.
__device__ __forceinline__ unsigned cvt_bf16x2_lo(float lo, float hi, unsigned rounded) {
  return cvt_bf16x2(lo - __uint_as_float(rounded << 16),
                    hi - __uint_as_float(rounded & 0xffff0000u));
}

// Lane (g, t) = (lane / 4, lane % 4) of a warp holds rows g and g + 8
// (index i = 0, 1) of its 16 query rows in S and O; accumulator element e
// is row e >> 1.

// S = Q K^T over one stage's BK keys. ka: this lane's ldmatrix row address
// in the K tile. Matrices (keys 16jj + 0..7, d 16kk + 0..7), (the same keys,
// d + 8), (keys + 8, d), (keys + 8, d + 8) are b0, b1 of n-tile 2jj and b0,
// b1 of n-tile 2jj + 1.
template <class T>
__device__ __forceinline__ void tc_qk(float (&s)[T::NT][4], unsigned ka,
                                      const unsigned (&qa)[T::D / 16][4]) {
#pragma unroll
  for (int j = 0; j < T::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < T::D / 16; ++kk)
#pragma unroll
    for (int jj = 0; jj < T::NT / 2; ++jj) {
      unsigned b[4];
      ldsm_x4(b, ka + jj * 16 * T::kRowBytes + kk * 32);
      mma_m16n8k16(s[2 * jj], qa[kk], b[0], b[1]);
      mma_m16n8k16(s[2 * jj + 1], qa[kk], b[2], b[3]);
    }
}

// O += P V over one stage, p as a bfloat16 pair hi + lo (hi = bf16(p), lo =
// bf16(p - hi): ~16 bits of p, the Pallas kernel's float32 p to ~2^-17),
// into two accumulator sets, acc[0] += hi V and acc[1] += lo V. k step kk
// (keys 16kk .. 16kk + 15) takes n-tiles 2kk and 2kk + 1 of P, repacked in
// registers, as its A fragments. va: this lane's ldmatrix row address in the
// V tile; matrices (keys 0..7, d 16n2 + 0..7), (keys 8..15, the same d),
// (keys 0..7, d + 8), (keys 8..15, d + 8), transposed, are b0, b1 of O's
// n-tile 2n2 and b0, b1 of n-tile 2n2 + 1.
template <class T>
__device__ __forceinline__ void tc_pv(const float (&p)[T::NT][4], unsigned va,
                                      float (&acc)[2][T::D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < T::NT / 2; ++kk) {
    const unsigned hi[4] = {cvt_bf16x2(p[2 * kk][0], p[2 * kk][1]),
                            cvt_bf16x2(p[2 * kk][2], p[2 * kk][3]),
                            cvt_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            cvt_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const unsigned lo[4] = {cvt_bf16x2_lo(p[2 * kk][0], p[2 * kk][1], hi[0]),
                            cvt_bf16x2_lo(p[2 * kk][2], p[2 * kk][3], hi[1]),
                            cvt_bf16x2_lo(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2]),
                            cvt_bf16x2_lo(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3])};
#pragma unroll
    for (int n2 = 0; n2 < T::D / 16; ++n2) {
      unsigned b[4];
      ldsm_x4_trans(b, va + kk * 16 * T::kRowBytes + n2 * 32);
      mma_m16n8k16(acc[0][2 * n2], hi, b[0], b[1]);
      mma_m16n8k16(acc[0][2 * n2 + 1], hi, b[2], b[3]);
      mma_m16n8k16(acc[1][2 * n2], lo, b[0], b[1]);
      mma_m16n8k16(acc[1][2 * n2 + 1], lo, b[2], b[3]);
    }
  }
}

template <class T, bool kMasked>
__device__ __forceinline__ void tc_mask(float (&s)[T::NT][4], int key0, int S) {
  if (kMasked) {
    const int k0 = key0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + (e & 1) >= S) s[j][e] = kNegInf;
  }
}

// One stage for a warp's 16 query rows: S = Q K^T, the online-softmax update
// in the accumulator layout, and O += P V.
template <class T, bool kMasked>
__device__ __forceinline__ void tc_stage(unsigned ka, unsigned va, int key0, int S, float c,
                                         const unsigned (&qa)[T::D / 16][4],
                                         float (&acc)[2][T::D / 8][4], float (&m)[2],
                                         float (&l)[2]) {
  constexpr int NT = T::NT;
  float s[NT][4];
  tc_qk<T>(s, ka, qa);
  tc_mask<T, kMasked>(s, key0, S);
  // Row max of the raw logits (c > 0 keeps their order): a tree over the
  // lane's keys, then over the quad of lanes that holds the row.
  float mx[2][NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0][j] = fmaxf(s[j][0], s[j][1]);
    mx[1][j] = fmaxf(s[j][2], s[j][3]);
  }
#pragma unroll
  for (int w = 1; w < NT; w *= 2)
#pragma unroll
    for (int j = 0; j + w < NT; j += 2 * w) {
      mx[0][j] = fmaxf(mx[0][j], mx[0][j + w]);
      mx[1][j] = fmaxf(mx[1][j], mx[1][j + w]);
    }
  float mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mn = fmaxf(m[i], mx[i][0]);
    mn = fmaxf(mn, __shfl_xor_sync(0xffffffffu, mn, 1));
    mn = fmaxf(mn, __shfl_xor_sync(0xffffffffu, mn, 2));
    const float corr = fast_exp2((m[i] - mn) * c);  // one correction a row and stage
    m[i] = mn;
    mc[i] = mn * c;
    l[i] *= corr;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < T::D / 8; ++n) {
        acc[h][n][2 * i] *= corr;
        acc[h][n][2 * i + 1] *= corr;
      }
  }
  // p = 2^(s c - m c): one FFMA and one ex2 a logit; l sums the float32 p.
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = fast_exp2(fmaf(s[j][e], c, -mc[e >> 1]));
      l[e >> 1] += s[j][e];
    }
  tc_pv<T>(s, va, acc);
}

template <class T>
__global__ void __launch_bounds__(T::kThreads)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                float c) {
  constexpr int D = T::D;
  constexpr int BK = T::BK;
  constexpr int ST = T::STAGES;
  constexpr int kChunks = BK * D / 8;  // 16-byte chunks of a K (or V) tile
  constexpr int kCopies = kChunks / T::kThreads;
  static_assert(kChunks % T::kThreads == 0, "whole copies a thread");
  __shared__ __align__(128) unsigned char smem[ST * T::kStageBytes];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = blockIdx.x * T::BQ + (threadIdx.x >> 5) * 16;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const unsigned sbase = smem_u32(smem);

  // A tile of BK keys is BK * D contiguous bfloat16 in memory: thread x
  // copies its chunks x, x + 128, ... of K and of V by 16-byte cp.async,
  // bfloat16 as they are, zero-filled past S.
  auto load_tile = [&](int t) {
    const unsigned kd = sbase + (t % ST) * T::kStageBytes;
#pragma unroll
    for (int n = 0; n < kCopies; ++n) {
      const int i = threadIdx.x + n * T::kThreads;
      const int r = i / (D / 8);
      const bool in = t * BK + r < S;
      const size_t off = in ? static_cast<size_t>(t) * BK * D + i * 8 : 0;
      const unsigned dst = kd + r * T::kRowBytes + (i % (D / 8)) * 16;
      ::cp_async16(dst, kb + off, in ? 16 : 0);
      ::cp_async16(dst + T::kTileBytes, vb + off, in ? 16 : 0);
    }
  };

  const int ntiles = (S + BK - 1) / BK;
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  // q as A fragments, unscaled bfloat16, loaded once; rows past S are 0.
  unsigned qa[D / 16][4];
  {
    const __nv_bfloat16* q0 = q + base + static_cast<size_t>(row0 + g) * D + 2 * t4;
    const bool in0 = row0 + g < S;
    const bool in1 = row0 + g + 8 < S;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = in0 ? *reinterpret_cast<const unsigned*>(q0 + 16 * kk) : 0u;
      qa[kk][1] = in1 ? *reinterpret_cast<const unsigned*>(q0 + 8 * D + 16 * kk) : 0u;
      qa[kk][2] = in0 ? *reinterpret_cast<const unsigned*>(q0 + 16 * kk + 8) : 0u;
      qa[kk][3] = in1 ? *reinterpret_cast<const unsigned*>(q0 + 8 * D + 16 * kk + 8) : 0u;
    }
  }
  float acc[2][D / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  // ldmatrix rows: lane gives row lane % 8 of matrix lane / 8 (tc_qk, tc_pv).
  const int mi = lane >> 3;
  const int r8 = lane & 7;
  const unsigned ka = sbase + ((mi >> 1) * 8 + r8) * T::kRowBytes + (mi & 1) * 16;
  const unsigned va = sbase + T::kTileBytes + ((mi & 1) * 8 + r8) * T::kRowBytes + (mi >> 1) * 16;

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    // Tile t has landed for every thread, and tile t - 1 is consumed, so its
    // stage may take tile t + ST - 1.
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (t + ST - 1 < ntiles) load_tile(t + ST - 1);
    cp_async_commit();
    const unsigned st = (t % ST) * T::kStageBytes;
    if (t * BK + BK <= S)
      tc_stage<T, false>(ka + st, va + st, t * BK, S, c, qa, acc, m, l);
    else  // the ragged last stage
      tc_stage<T, true>(ka + st, va + st, t * BK, S, c, qa, acc, m, l);
  }

  // l: the quad's partial sums; O: hi V + lo V. Fixed orders.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + g + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + base + static_cast<size_t>(row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(orow + 8 * n) =
          cvt_bf16x2((acc[0][n][2 * i] + acc[1][n][2 * i]) / l[i],
                     (acc[0][n][2 * i + 1] + acc[1][n][2 * i + 1]) / l[i]);
  }
}

template <class T>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH, int S, float c,
              cudaStream_t stream) {
  const dim3 grid((S + T::BQ - 1) / T::BQ, BH);
  flash_tc_kernel<T><<<grid, T::kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (BH, S, D) float32, contiguous and 16-byte aligned; D in
// {16, 32, 64}. qk_scale_log2 = log2(e) / sqrt(D).
SSHSLIE_EXPORT int sshslie_flash_attn_f32(const void* q, const void* k,
                                          const void* v, void* o, int BH,
                                          int S, int D, float qk_scale_log2,
                                          void* stream) {
  return flash_entry<float>(q, k, v, o, BH, S, D, qk_scale_log2, stream);
}

// The same with q, k, v and o in bfloat16, on the tensor cores (float32 m,
// l and accumulator; p as described at the top).
SSHSLIE_EXPORT int sshslie_flash_attn_bf16(const void* q, const void* k,
                                           const void* v, void* o, int BH,
                                           int S, int D, float qk_scale_log2,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_tc<TcTiles<16, 128, 3>>(q, k, v, o, BH, S, qk_scale_log2, s);
    case 32:
      return launch_tc<TcTiles<32, 64, 3>>(q, k, v, o, BH, S, qk_scale_log2, s);
    case 64:
      return launch_tc<TcTiles<64, 64, 2>>(q, k, v, o, BH, S, qk_scale_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
