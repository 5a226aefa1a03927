// Stride-1 SAME k x k convolution, 64 -> 64 channels, float32 accumulation:
// the DecompositionNet's 9x9 shallow conv, with a float32 and a bfloat16
// entry.
//
// Replaces: sshslie_tpu/ops/conv_pallas.py::conv9_fwd (Pallas kernel
// _fwd_kernel). Same function: y[b,h,w,co] = sum_{kh,kw,ci}
// xpad[b,h+kh,w+kw,ci] * w[kh,kw,ci,co], NHWC x HWIO -> NHWC, no bias (the
// wrapper adds it outside, as the JAX package does). The TPU kernel's
// width-pairing to 128 lanes and its W % 128 gate are MXU tiling rules and
// are not carried over: any H, W works here, the ragged edge is masked.
// Both entries also serve the input gradient (ShallowConv.backward, as
// _psc_bwd), with the reversed and transposed weights.
//
// float32 entry (sshslie_conv_c64_f32). What bounds it on an H100:
// arithmetic. One 512x512x64 forward at k = 9 is 2*512^2*81*64*64 = 1.74e11
// FLOP against ~135 MB in and out, so ~1300 FLOP a byte; float32 outside the
// tensor cores (full float32) peaks at 67 TFLOP/s, which makes
// 2.6 ms the floor, against 0.04 ms for the bytes. Design, an implicit GEMM
// on the CUDA cores:
//   * A block of 256 threads owns an 8 x 32 pixel output tile and all 64
//     output channels. Thread (pixel group, channel group) keeps 8 pixels of
//     one row times 8 channels (co = 4g..4g+3 and 32+4g..32+4g+3) in 64
//     registers.
//   * The 64 input channels are walked in chunks of 4. Per chunk the block
//     stages the halo'd input window ((8+k-1) x (32+k-1) pixels x 4 channels,
//     zero outside the image) and all k*k taps of the chunk's weights
//     (k*k x 4 x 64) in shared memory: 93 KB at k = 9, so two blocks share an
//     SM.
//   * Per (channel, kh) a thread loads its 8+k-1 input values of one row into
//     registers once and reuses them for all k taps of that row: per tap it
//     reads two float4 of weights (conflict-free: 8 channel groups cover the
//     32 banks) for 64 FMA.
//
// bfloat16 entry (sshslie_conv_c64_bf16): bfloat16 x and w, float32 sums,
// the output rounded to bfloat16 once (conv_pallas.py::conv9_fwd on bfloat16
// operands, preferred_element_type float32). What bounds it: the same 1.74e11
// FLOP at 512^2 on the tensor cores (989 TFLOP/s dense bfloat16) is 0.176
// ms, against 0.04 ms for the bytes. mma.sync tops out near two thirds of
// that rate on an H100, so the products run as wgmma, and the design counts
// the shared-memory bytes each product needs. An implicit GEMM with the
// roles turned round, M = 64 output channels, N = output pixels, K = k*k
// taps x 64 input channels:
//   * A block of 256 threads (2 warpgroups) owns an 8 x 64 output tile and
//     all 64 output channels, one block an SM. Its whole halo'd input tile,
//     all 64 channels in bfloat16, stays in shared memory for the block's
//     life: (8+k-1) x (64+k-1) pixel rows of 128 bytes, 144 KB at k = 9,
//     190 KB at k = 13 (with the weight ring 223 KB, inside the 227 KB a
//     block may have). It comes in by cp.async, the zero padding outside the
//     image by src-size 0.
//   * The weights stream one tap (64 x 64 bfloat16, 8 KB, HWIO as given) at a
//     time through a ring of 4 cp.async stages. One __syncthreads a tap.
//   * A, the tap's weights as co x ci, goes to registers by ldmatrix.x4.trans
//     (HWIO keeps co contiguous, so the transposing load gives the row-major
//     fragment: no host-side repacking, for the forward or the dgrad
//     weights); warp w of a warpgroup holds channels 16w .. 16w+15.
//   * B, the input pixels, is never loaded by the threads: per output row
//     and 16 input channels one wgmma m64n64k16 reads the row's 64 pixels,
//     shifted by the tap, straight from the input tile through a descriptor
//     (a shift (kh, kw) is only another start row). Warpgroup g owns tile
//     rows 4g .. 4g+3: 4 x 32 float32 accumulators a thread.
//   * A tap's 16 wgmma of a warpgroup are committed as one group; A is
//     double-buffered in registers, so the tensor cores run tap t while the
//     threads wait for tap t+1's weights and load its fragments.
//   * Every 128-byte row in shared memory stores its 16-byte chunk c at
//     c ^ (row & 7) (mma.cuh): wgmma's 128-byte swizzle, and conflict-free
//     for ldmatrix.
//   * The accumulators are rounded to bfloat16 once, staged through shared
//     memory (the input tile's space, after a barrier) as [pixel][co] rows
//     and stored as 16-byte rows; the ragged edge is masked per pixel.
//   * Shared-memory reads: a warpgroup's tap and k step moves 8 KB of input
//     rows (wgmma) and 2 KB of weight fragments (ldmatrix) for 262,144
//     multiply-adds, against 16 KB when both operands go through ldmatrix
//     into mma.sync fragments. L2 traffic of the weights: every 512-pixel
//     tile reads all k*k taps, 663 KB at k = 9: 0.34 GB at 512^2, 0.17 GB at
//     b8 x 128^2.
//   * Measured on an H100 (PERF.md, PR 5): 60% of the tensor cores' bound
//     at 512^2. Neither 4 warpgroups of 32-pixel rows nor 64-pixel rows
//     (this form) moved it, so the wgmma shape is not what holds it; the
//     per-tap barrier and the unoverlapped tile load and epilogue of one
//     block an SM are what is left to try.
//
// TF32 entry (sshslie_conv_c64_tf32): float32 x and w, each operand rounded
// to TF32 (to nearest, ties away from zero: cvt.rna), products on the
// tensor cores, float32 sums: conv_pallas.py::conv9_fwd under
// matmul_precision tensorfloat32 (XLA's TF32 passes on a GPU). What bounds
// it: the same 1.74e11 FLOP at 512^2 at the dense TF32 rate (495 TFLOP/s)
// is 0.351 ms, against 0.040 ms for the float32 bytes; 0.0439 ms at the
// training shape b2 x 128^2. The bfloat16 kernel's turned-round GEMM on
// wgmma m64n64k8 .tf32 (M = 64 output channels, N = 64 output pixels of a
// tile row, K = k*k taps x 64 input channels):
//   * .tf32 wgmma reads B K-major only. B is the pixels: a pixel's input
//     channels are contiguous in NHWC, so the halo tile's rows are K-major
//     as they lie. A is the tap's weights as co x ci, from registers, so
//     it needs no transposing load.
//   * A block of 256 threads (2 warpgroups) owns a 4 x 64 output tile and
//     all 64 output channels; warpgroup g computes tile rows 2g and 2g+1.
//     4 x 64 tiles give 128 blocks at b2 x 128^2, one wave. N = 64: with
//     two warpgroups an SM and 4 accumulator tiles each, m64n32k8 .tf32 ran
//     at 247 TFLOP/s and m64n64k8 at 401 (tools/tc_probe, PERF.md).
//   * The float32 halo tile with all 64 channels does not fit beside the
//     weights at k = 13, so the input channels go in two passes of 32: a
//     pixel's 32 channels are one 128-byte row, in wgmma's 128-byte swizzle
//     ((4+k-1) x (64+k-1) rows: 108 KB at k = 9, 152 KB at k = 13). A k8
//     step of TF32 is 32 bytes of the row: the descriptor's start moves by
//     32 bytes a k step, and a tap (kh, kw) is another start row.
//   * The weights stream one tap (32 ci x 64 co, [ci][co] rows padded to
//     72 floats) at a time through a ring of 8 stages in shared memory,
//     refilled two taps at a time after one __syncthreads every two taps:
//     each thread fetches its 16-byte chunks of taps t+8, t+9 into
//     registers (__ldg) at tap t, and at tap t+2 rounds them (cvt.rna) and
//     stores them into the stages that taps t, t+1 freed. Warp w of a
//     warpgroup loads its A fragments (co 16w .. 16w+15) by 32-bit loads,
//     conflict-free on the 72-float rows (bank 8t + g + 16w),
//     double-buffered across taps as in the bfloat16 kernel: the tensor
//     cores run tap t while the threads load tap t+1's fragments.
//   * Rounding: the tensor cores ignore the low 13 bits of a .tf32 operand,
//     so an unrounded float32 would be truncated. The weights are rounded
//     once, on their way into the ring (above), so the fragment loads find
//     TF32 values. cp.async copies bytes, so the input tile is rounded in
//     shared memory once a pass: each thread rounds the chunks it copied,
//     after they land and before the fence and barrier that publish them
//     to wgmma.
//   * The tensor cores' float32 sums are not IEEE adds (they truncate),
//     which would bias a long chain of products by up to ~0.5 ulp a step.
//     One kernel row's products (k taps x 32 channels) go into fresh
//     accumulators that are then added to the running sums by float32
//     adds: no chain runs longer than one kernel row. 2 rows x 32 running
//     and 2 x 32 fresh accumulators a thread, one block an SM. The flush at
//     a row's end waits for the row's products after the next tap's
//     fragments are loaded. Measured on an H100: uncut chains are 1.5e-5 of
//     the largest output off the TF32 plain version at k = 9 and 2.9e-5 at
//     k = 13, against 1.1e-6 / 1.4e-6 with the cut (the tolerance is 1e-5).
//   * Measured on an H100 (PERF.md, PR 11): 50% of the bound at 512^2 and
//     at b2 x 128^2, ahead of cuDNN's TF32 call. The steps there, at 512^2:
//     m64n32k8 with a barrier and a cp.async refill a tap and the weights
//     rounded as their fragments loaded, 0.87 ms; m64n64k8 0.84; a barrier
//     every two taps (8 stages) 0.78; the weights rounded once on their way
//     in 0.70. Tried and dropped: a deeper ring alone, L2 cache hints, a
//     barrier every 4 taps, the refill after the fragment loads, a third A
//     buffer, 8-byte A loads (output channels permuted), bulk copies with
//     mbarriers (2.4x slower: one copy a 256-byte row), the cut staggered
//     between the warpgroups, the tile's loads split by rows (more
//     registers, slower), a pass's first taps by cp.async rounded in place
//     (0.79), two pairs of taps in flight at a pass's start. The tensor
//     cores alone (tools/tc_probe, 2 warpgroups x 2 accumulators) would
//     take 0.37 ms.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kC = 64;         // input and output channels
constexpr int kTH = 8;         // output tile rows per block
constexpr int kTW = 32;        // output tile columns per block
constexpr int kCC = 4;         // input channels staged per chunk (float32 entry)
constexpr int kPix = 8;        // output pixels per thread (float32 entry)
constexpr int kThreads = 256;  // 32 pixel groups x 8 channel groups

template <int K>
struct Tile {
  static constexpr int kInH = kTH + K - 1;
  static constexpr int kInW = kTW + K - 1;
  static constexpr int kInFloats = kCC * kInH * kInW;
  static constexpr int kWFloats = K * K * kCC * kC;
  static constexpr int kSmemBytes = 4 * (kWFloats + kInFloats);
};

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
conv_c64_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, int H, int W) {
  using T = Tile<K>;
  constexpr int P = (K - 1) / 2;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [K*K][kCC][kC]
  float* xs = ws + T::kWFloats;                 // [kCC][kInH][kInW]

  const int tid = threadIdx.x;
  const int cg = tid & 7;             // channel group
  const int pg = tid >> 3;            // pixel group, 0..31
  const int prow = pg >> 2;           // tile row, 0..7
  const int pcol = (pg & 3) * kPix;   // tile column of the first pixel
  const int h0 = blockIdx.y * kTH;
  const int w0 = blockIdx.x * kTW;
  const float* xb = x + static_cast<size_t>(blockIdx.z) * H * W * kC;

  float acc[kPix][8];
#pragma unroll
  for (int j = 0; j < kPix; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;

  for (int ci0 = 0; ci0 < kC; ci0 += kCC) {
    __syncthreads();  // the previous chunk is consumed
    // Weights of this chunk, [tap][cc][co], one float4 a step.
    for (int i = tid; i < K * K * kCC * (kC / 4); i += kThreads) {
      const int q = i % (kC / 4);
      const int cc = (i / (kC / 4)) % kCC;
      const int tap = i / ((kC / 4) * kCC);
      reinterpret_cast<float4*>(ws)[i] =
          load4(w + (static_cast<size_t>(tap) * kC + ci0 + cc) * kC + q * 4);
    }
    // Halo'd input window of this chunk, zero outside the image.
    for (int i = tid; i < T::kInH * T::kInW; i += kThreads) {
      const int iy = i / T::kInW;
      const int ix = i % T::kInW;
      const int gh = h0 - P + iy;
      const int gw = w0 - P + ix;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = load4(xb + (static_cast<size_t>(gh) * W + gw) * kC + ci0);
      xs[(0 * T::kInH + iy) * T::kInW + ix] = v.x;
      xs[(1 * T::kInH + iy) * T::kInW + ix] = v.y;
      xs[(2 * T::kInH + iy) * T::kInW + ix] = v.z;
      xs[(3 * T::kInH + iy) * T::kInW + ix] = v.w;
    }
    __syncthreads();

#pragma unroll 1
    for (int cc = 0; cc < kCC; ++cc) {
#pragma unroll 1
      for (int kh = 0; kh < K; ++kh) {
        const float* row = xs + (cc * T::kInH + prow + kh) * T::kInW + pcol;
        float xr[kPix + K - 1];
#pragma unroll
        for (int t = 0; t < kPix + K - 1; ++t) xr[t] = row[t];
        const float* wrow = ws + (kh * K * kCC + cc) * kC;
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float* wt = wrow + kw * kCC * kC;
          const float4 wa = *reinterpret_cast<const float4*>(wt + cg * 4);
          const float4 wb = *reinterpret_cast<const float4*>(wt + 32 + cg * 4);
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            const float xv = xr[j + kw];
            acc[j][0] = fmaf(xv, wa.x, acc[j][0]);
            acc[j][1] = fmaf(xv, wa.y, acc[j][1]);
            acc[j][2] = fmaf(xv, wa.z, acc[j][2]);
            acc[j][3] = fmaf(xv, wa.w, acc[j][3]);
            acc[j][4] = fmaf(xv, wb.x, acc[j][4]);
            acc[j][5] = fmaf(xv, wb.y, acc[j][5]);
            acc[j][6] = fmaf(xv, wb.z, acc[j][6]);
            acc[j][7] = fmaf(xv, wb.w, acc[j][7]);
          }
        }
      }
    }
  }

  const int oh = h0 + prow;
  if (oh >= H) return;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int ow = w0 + pcol + j;
    if (ow < W) {
      float* o = y + ((static_cast<size_t>(blockIdx.z) * H + oh) * W + ow) * kC;
      store4(o + cg * 4, make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
      store4(o + 32 + cg * 4, make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]));
    }
  }
}

// ---- bfloat16 entry: tensor cores ----

constexpr int kTHb = 8;                     // output tile rows per block (2 warpgroups x 4)
constexpr int kTWb = 64;                    // output tile columns per block
constexpr int kWgRows = kTHb / 2;           // tile rows a warpgroup computes
constexpr int kWStages = 4;                 // weight taps in shared memory
constexpr int kTapBytes = kC * kC * 2;      // one tap of bfloat16 weights, 8 KB

template <int K>
struct TcTile {
  static constexpr int kInH = kTHb + K - 1;
  static constexpr int kInW = kTWb + K - 1;
  static constexpr int kInBytes = kInH * kInW * kC * 2;
  // 1024 bytes of slack: the input tile's base is rounded up to the swizzle
  // pattern's 1024-byte period that wgmma's descriptors assume.
  static constexpr int kSmemBytes = 1024 + kInBytes + kWStages * kTapBytes;
  static_assert(kInBytes >= kTHb * kTWb * kC * 2, "the output staging reuses the input tile");
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
conv_c64_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y, int H, int W) {
  using T = TcTile<K>;
  constexpr int P = (K - 1) / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned xs = (smem_u32(smem) + 1023) & ~1023u;  // [kInH * kInW pixels][64 ci], swizzled
  const unsigned ws = xs + T::kInBytes;                  // [kWStages][64 ci][64 co], swizzled

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;         // warpgroup: tile rows kWgRows wg .. kWgRows (wg + 1) - 1
  const int wq = (tid >> 5) & 3;   // warp of the warpgroup: output channels 16 wq .. 16 wq + 15
  const int h0 = blockIdx.y * kTHb;
  const int w0 = blockIdx.x * kTWb;
  const __nv_bfloat16* xb = x + static_cast<size_t>(blockIdx.z) * H * W * kC;

  // The halo'd input tile, zero outside the image.
  for (int i = tid; i < T::kInH * T::kInW * 8; i += kThreads) {
    const int p = i >> 3;
    const int c = i & 7;
    const int iy = p / T::kInW;
    const int gh = h0 - P + iy;
    const int gw = w0 - P + (p - iy * T::kInW);
    const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
    const __nv_bfloat16* src = in ? xb + (static_cast<size_t>(gh) * W + gw) * kC + c * 8 : xb;
    cp_async16(xs + swz128(p, c), src, in ? 16 : 0);
  }
  auto load_tap = [&](int tap) {
    const __nv_bfloat16* src = w + static_cast<size_t>(tap) * kC * kC;
    const unsigned dst = ws + (tap % kWStages) * kTapBytes;
    for (int i = tid; i < kC * 8; i += kThreads)
      cp_async16(dst + swz128(i >> 3, i & 7), src + i * 8, 16);
  };
  // Group 0: the input tile and tap 0; then one group a tap (K * K >= 9 taps).
  for (int tap = 0; tap < kWStages - 1; ++tap) {
    load_tap(tap);
    cp_async_commit();
  }

  // acc[j]: output channels (M) x the 64 pixels of tile row kWgRows wg + j (N).
  float acc[kWgRows][32];
#pragma unroll
  for (int j = 0; j < kWgRows; ++j)
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[j][c] = 0.f;

  // A, the tap's weights as co x ci, by ldmatrix.x4.trans from the [ci][co]
  // rows: lane l addresses ci row (l & 7) + 8 (l >> 4) of the 16-wide k step
  // and the co chunk 2 wq + ((l >> 3) & 1).
  const int arow = (lane & 7) + ((lane >> 4) << 3);
  const int achunk = 2 * wq + ((lane >> 3) & 1);
  // B, the pixels of tile row kWgRows wg + j shifted by the tap: pixel rows
  // of the input tile, read by wgmma from shared memory.
  const unsigned long long desc0 = wgmma_desc(xs + (kWgRows * wg) * T::kInW * 128);
  unsigned a[2][4][4];  // two taps of A fragments: one being read by wgmma, one being loaded

  // One tap: its weights' A fragments into a[par], then 4 k steps x
  // kWgRows rows of wgmma, committed as one group.
  auto run_tap = [&](int tap, auto par_tag) {
    constexpr int par = decltype(par_tag)::value;
    cp_async_wait<kWStages - 2>();  // this tap (and, at tap 0, the input) landed
    if (tap == 0) fence_proxy_async();  // the input tile, written by cp.async, is read by wgmma
    __syncthreads();  // ... for all threads; and tap - 1's weight slot is free again
    if (tap + kWStages - 1 < K * K) load_tap(tap + kWStages - 1);
    cp_async_commit();  // possibly empty: keeps one group per tap
    wgmma_wait<1>();    // tap - 2's products are done: a[par] is free
    const unsigned wslot = ws + (tap % kWStages) * kTapBytes;
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks) ldsm_x4_trans(a[par][ks], wslot + swz128(ks * 16 + arow, achunk));
    wgmma_fence();
    const int kh = tap / K;
    const int kw = tap - kh * K;
    const unsigned long long dtap = desc0 + (((kh * T::kInW + kw) * 128) >> 4);
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks)
#pragma unroll
      for (int j = 0; j < kWgRows; ++j)
        wgmma_m64n64k16<0>(acc[j], a[par][ks], dtap + ((j * T::kInW * 128 + ks * 32) >> 4));
    wgmma_commit();
  };

#pragma unroll 1
  for (int tap = 0; tap < K * K; tap += 2) {
    run_tap(tap, std::integral_constant<int, 0>());
    if (tap + 1 < K * K) run_tap(tap + 1, std::integral_constant<int, 1>());
  }

  // Epilogue: round once, stage the tile's 512 x 64 outputs through shared
  // memory as [pixel][co] rows, store 16-byte rows.
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the input tile
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < kWgRows; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int co = 16 * wq + g + 8 * ((i >> 1) & 1);
      const int px = (kWgRows * wg + j) * kTWb + 8 * (i >> 2) + 2 * q + (i & 1);
      const unsigned short v = __bfloat16_as_ushort(__float2bfloat16_rn(acc[j][i]));
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(xs + swz128(px, co >> 3) + (co & 7) * 2),
                   "h"(v)
                   : "memory");
    }
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < kTHb * kTWb * 8; i += kThreads) {
    const int px = i >> 3;
    const int c = i & 7;
    const int oh = h0 + px / kTWb;
    const int ow = w0 + px % kTWb;
    if (oh < H && ow < W) {
      uint4 v;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(xs + swz128(px, c))
                   : "memory");
      *reinterpret_cast<uint4*>(
          y + ((static_cast<size_t>(blockIdx.z) * H + oh) * W + ow) * kC + c * 8) = v;
    }
  }
}

// ---- TF32 entry: tensor cores, wgmma m64n64k8 ----

constexpr int kTHt = 4;                    // output tile rows per block (2 warpgroups x 2)
constexpr int kTWt = 64;                   // output tile columns per block: wgmma's N
constexpr int kWgRowsT = kTHt / 2;         // tile rows a warpgroup computes
constexpr int kCCt = 32;                   // input channels of a pass: one 128-byte row a pixel
constexpr int kWStagesT = 8;               // weight taps in shared memory
constexpr int kWRowT = 72;                 // floats a weight row (64 co + 8): conflict-free A loads
constexpr int kTapFloatsT = kCCt * kWRowT;

template <int K>
struct Tf32Tile {
  static constexpr int kInH = kTHt + K - 1;
  static constexpr int kInW = kTWt + K - 1;
  static constexpr int kInPix = kInH * kInW;
  static constexpr int kInBytes = kInPix * 128;
  // 1024 bytes of slack: the tile's base is rounded up to the swizzle's period.
  static constexpr int kSmemBytes = 1024 + kInBytes + kWStagesT * kTapFloatsT * 4;
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
conv_c64_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int H, int W) {
  using T = Tf32Tile<K>;
  constexpr int P = (K - 1) / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned xs = (smem_u32(smem) + 1023) & ~1023u;  // [kInPix][32 ci], swizzled
  unsigned char* const xsp = smem + (xs - smem_u32(smem));
  float* const wst = reinterpret_cast<float*>(xsp + T::kInBytes);  // [stage][32 ci][kWRowT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;         // warpgroup: tile rows kWgRowsT wg .. kWgRowsT (wg + 1) - 1
  const int wq = (tid >> 5) & 3;   // warp of the warpgroup: output channels 16 wq .. 16 wq + 15
  const int g = lane >> 2;
  const int q = lane & 3;
  const int h0 = blockIdx.y * kTHt;
  const int w0 = blockIdx.x * kTWt;
  const float* xb = x + static_cast<size_t>(blockIdx.z) * H * W * kC;

  // The halo'd tile of channels ci0 .. ci0+31, zero outside the image.
  auto load_tile = [&](int ci0) {
    for (int i = tid; i < T::kInPix * 8; i += kThreads) {
      const int p = i >> 3;
      const int c = i & 7;
      const int iy = p / T::kInW;
      const int gh = h0 - P + iy;
      const int gw = w0 - P + (p - iy * T::kInW);
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const float* src = in ? xb + (static_cast<size_t>(gh) * W + gw) * kC + ci0 + c * 4 : xb;
      cp_async16(xs + swz128(p, c), src, in ? 16 : 0);
    }
  };
  // Each thread rounds the chunks it copied (load_tile's index pattern).
  auto round_tile = [&]() {
    for (int i = tid; i < T::kInPix * 8; i += kThreads)
      round16_tf32(reinterpret_cast<float*>(xsp + swz128(i >> 3, i & 7)));
  };
  // Taps t0, t0 + 1's weights for channels ci0 .. ci0+31 (32 rows of 64
  // co each, two 16-byte chunks a thread a tap): fetched into registers,
  // then rounded and stored into their stages two taps later, so the
  // fragment loads find TF32 values.
  static_assert(kCCt * 16 == 2 * kThreads, "two weight chunks a thread a tap");
  float4 wreg[4];
  auto fetch_pair = [&](int ci0, int t0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int tap = t0 + (u >> 1);
      const int i = tid + (u & 1) * kThreads;
      if (tap < K * K)
        wreg[u] = __ldg(reinterpret_cast<const float4*>(
            w + (static_cast<size_t>(tap) * kC + ci0 + (i >> 4)) * kC + (i & 15) * 4));
    }
  };
  auto store_pair = [&](int t0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int tap = t0 + (u >> 1);
      const int i = tid + (u & 1) * kThreads;
      if (tap < K * K) {
        const float4 v = wreg[u];
        *reinterpret_cast<float4*>(wst + (tap % kWStagesT) * kTapFloatsT + (i >> 4) * kWRowT +
                                   (i & 15) * 4) =
            make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      }
    }
  };

  // acc[j]: the running sums, output channels (M) x the 64 pixels of tile
  // row kWgRowsT wg + j (N); part[j]: the current kernel row's products.
  float acc[kWgRowsT][32];
  float part[kWgRowsT][32];
#pragma unroll
  for (int j = 0; j < kWgRowsT; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = part[j][i] = 0.f;

  // B, the pixels of tile row kWgRowsT wg + j shifted by the tap, read by
  // wgmma from the tile.
  const unsigned long long desc0 = wgmma_desc(xs + (kWgRowsT * wg) * T::kInW * 128);
  // A fragments of two taps (one being read by wgmma, one being loaded):
  // [k step][register], rounded to TF32.
  unsigned a[2][kCCt / 8][4];
  const int arow = q * kWRowT + 16 * wq + g;  // ci row q, co 16 wq + g of a k step

  // At even taps a barrier publishes the weights stored two taps earlier
  // (at tap 0 also the tile, rounded) and frees the last two taps' stages,
  // which take the fetched pair; then tap `tap`'s A fragments into a[par]
  // once tap - 2's products are done.
  auto prepare = [&](int ci0, int tap, auto par_tag) {
    constexpr int par = decltype(par_tag)::value;
    if ((tap & 1) == 0) {  // a barrier every two taps
      if (tap == 0) {
        cp_async_wait<0>();  // the tile landed
        round_tile();
        fence_proxy_async();  // the tile, written by cp.async and rounded, is read by wgmma
      }
      __syncthreads();  // taps tap, tap + 1 stored; taps tap - 2, tap - 1's slots are free again
      if (tap > 0) {
        store_pair(tap + kWStagesT - 2);
        fetch_pair(ci0, tap + kWStagesT);
      }
    }
    wgmma_wait<1>();    // tap - 2's products are done: a[par] is free
    const float* wt = wst + (tap % kWStagesT) * kTapFloatsT + arow;
#pragma unroll
    for (int ks = 0; ks < kCCt / 8; ++ks) {
      const float* r = wt + 8 * ks * kWRowT;
      a[par][ks][0] = __float_as_uint(r[0]);
      a[par][ks][1] = __float_as_uint(r[8]);
      a[par][ks][2] = __float_as_uint(r[4 * kWRowT]);
      a[par][ks][3] = __float_as_uint(r[4 * kWRowT + 8]);
    }
  };
  // The kernel row's products into the running sums (after wgmma_wait<0>).
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < kWgRowsT; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[j][i] += part[j][i];
        part[j][i] = 0.f;
      }
  };
  // One tap: 4 k steps x kWgRowsT rows of wgmma, committed as one group.
  auto issue = [&](int tap, auto par_tag) {
    constexpr int par = decltype(par_tag)::value;
    wgmma_fence();
    const int kh = tap / K;
    const int kw = tap - kh * K;
    const unsigned long long dtap = desc0 + (((kh * T::kInW + kw) * 128) >> 4);
#pragma unroll
    for (int ks = 0; ks < kCCt / 8; ++ks)
#pragma unroll
      for (int j = 0; j < kWgRowsT; ++j)
        wgmma_m64n64k8_tf32(part[j], a[par][ks], dtap + ((j * T::kInW * 128 + ks * 32) >> 4));
    wgmma_commit();
  };
  auto step = [&](int ci0, int tap, auto par_tag) {
    prepare(ci0, tap, par_tag);
    if (tap > 0 && tap % K == 0) {  // a kernel row ended with tap - 1
      wgmma_wait<0>();
      flush();
    }
    issue(tap, par_tag);
  };

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int ci0 = pass * kCCt;
    if (pass) __syncthreads();  // every warpgroup is done with the first pass's tile and weights
    // The tile by cp.async; taps 0 .. kWStagesT - 1 rounded into their
    // stages; the next pair's fetch in flight.
    load_tile(ci0);
    cp_async_commit();
    for (int t = 0; t < kWStagesT; t += 2) {
      fetch_pair(ci0, t);
      store_pair(t);
    }
    fetch_pair(ci0, kWStagesT);
#pragma unroll 1
    for (int tap = 0; tap < K * K; tap += 2) {
      step(ci0, tap, std::integral_constant<int, 0>());
      if (tap + 1 < K * K) step(ci0, tap + 1, std::integral_constant<int, 1>());
    }
    wgmma_wait<0>();
    flush();
  }

  // Epilogue: acc[j][i] is output channel 16 wq + g + 8 ((i >> 1) & 1) of
  // pixel 8 (i >> 2) + 2 q + (i & 1) of tile row kWgRowsT wg + j.
#pragma unroll
  for (int j = 0; j < kWgRowsT; ++j) {
    const int oh = h0 + kWgRowsT * wg + j;
    if (oh >= H) break;
    float* yrow = y + (static_cast<size_t>(blockIdx.z) * H + oh) * W * kC + 16 * wq + g;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ow = w0 + 8 * (i >> 2) + 2 * q + (i & 1);
      if (ow < W) yrow[static_cast<size_t>(ow) * kC + 8 * ((i >> 1) & 1)] = acc[j][i];
    }
  }
}

template <int K>
int launch(const float* x, const float* w, float* y, int B, int H, int W, cudaStream_t stream) {
  constexpr int kSmem = Tile<K>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv_c64_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  conv_c64_kernel<K><<<grid, kThreads, kSmem, stream>>>(x, w, y, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, int B, int H,
           int W, cudaStream_t stream) {
  constexpr int kSmem = TcTile<K>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv_c64_bf16_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTWb - 1) / kTWb, (H + kTHb - 1) / kTHb, B);
  conv_c64_bf16_kernel<K><<<grid, kThreads, kSmem, stream>>>(x, w, y, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_tf32(const float* x, const float* w, float* y, int B, int H, int W,
                cudaStream_t stream) {
  constexpr int kSmem = Tf32Tile<K>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv_c64_tf32_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTWt - 1) / kTWt, (H + kTHt - 1) / kTHt, B);
  conv_c64_tf32_kernel<K><<<grid, kThreads, kSmem, stream>>>(x, w, y, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int conv_entry(const void* x, const void* w, void* y, int B, int H, int W, int K,
               void* stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 3: return launch<3>(xt, wt, yt, B, H, W, s);
    case 5: return launch<5>(xt, wt, yt, B, H, W, s);
    case 7: return launch<7>(xt, wt, yt, B, H, W, s);
    case 9: return launch<9>(xt, wt, yt, B, H, W, s);
    case 11: return launch<11>(xt, wt, yt, B, H, W, s);
    case 13: return launch<13>(xt, wt, yt, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (B, H, W, 64) float32, w: (K, K, 64, 64) float32 HWIO, y: (B, H, W, 64)
// float32; all contiguous and 16-byte aligned. K odd, 3..13.
SSHSLIE_EXPORT int sshslie_conv_c64_f32(const void* x, const void* w, void* y,
                                        int B, int H, int W, int K,
                                        void* stream) {
  return conv_entry<float>(x, w, y, B, H, W, K, stream);
}

// The same with x, w and y in bfloat16 (float32 accumulation).
SSHSLIE_EXPORT int sshslie_conv_c64_bf16(const void* x, const void* w, void* y,
                                         int B, int H, int W, int K,
                                         void* stream) {
  return conv_entry<__nv_bfloat16>(x, w, y, B, H, W, K, stream);
}

// The same as sshslie_conv_c64_f32 with both operands rounded to TF32 and
// the products on the tensor cores (float32 sums).
SSHSLIE_EXPORT int sshslie_conv_c64_tf32(const void* x, const void* w, void* y,
                                         int B, int H, int W, int K,
                                         void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 3: return launch_tf32<3>(xf, wf, yf, B, H, W, s);
    case 5: return launch_tf32<5>(xf, wf, yf, B, H, W, s);
    case 7: return launch_tf32<7>(xf, wf, yf, B, H, W, s);
    case 9: return launch_tf32<9>(xf, wf, yf, B, H, W, s);
    case 11: return launch_tf32<11>(xf, wf, yf, B, H, W, s);
    case 13: return launch_tf32<13>(xf, wf, yf, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
