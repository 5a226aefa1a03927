// Blockwise softmax(Q K^T / sqrt(d)) V with an online softmax, float32, on the
// CUDA cores of an H100.
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
//
// bfloat16 entry (sshslie_flash_attn_bf16): the same kernel on bfloat16 q, k
// and v (attention.py::flash_attention on bfloat16 operands). q is widened to
// float32 and scaled in float32; K/V tiles are loaded and widened to float32
// on their way into shared memory (a plain load a thread, not cp.async, which
// cannot convert); m, l, the accumulator and the probabilities p stay float32
// (the Pallas kernel casts p to float32 too), and the output is rounded to
// bfloat16 once. The -1e30 mask past S is unchanged. Its floor is that of the
// float32 kernel; on the tensor cores the work's own floor would be the SFU's
// exponentials, ~16 us at (1, 4, 4096, 16).
#include <type_traits>

#include "common.cuh"

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

}  // namespace

// q, k, v, o: (BH, S, D) float32, contiguous and 16-byte aligned; D in
// {16, 32, 64}. qk_scale_log2 = log2(e) / sqrt(D).
SSHSLIE_EXPORT int sshslie_flash_attn_f32(const void* q, const void* k,
                                          const void* v, void* o, int BH,
                                          int S, int D, float qk_scale_log2,
                                          void* stream) {
  return flash_entry<float>(q, k, v, o, BH, S, D, qk_scale_log2, stream);
}

// The same with q, k, v and o in bfloat16 (float32 m, l, p and accumulator).
SSHSLIE_EXPORT int sshslie_flash_attn_bf16(const void* q, const void* k,
                                           const void* v, void* o, int BH,
                                           int S, int D, float qk_scale_log2,
                                           void* stream) {
  return flash_entry<__nv_bfloat16>(q, k, v, o, BH, S, D, qk_scale_log2, stream);
}
