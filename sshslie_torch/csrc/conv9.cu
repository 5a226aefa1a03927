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
// training shape b2 x 128^2. A simple kernel, right first, on mma.sync
// m16n8k8 .tf32: wgmma takes .tf32 operands K-major only, and the
// bfloat16 kernel's A (weights by a transposing ldmatrix) does not carry
// over, as ldmatrix transposes 16-bit elements only. An implicit GEMM with
// M = output pixels, N = 64 output channels, K = k*k taps x 64 input
// channels:
//   * A block of 256 threads owns an 8 x 32 output tile and all 64 output
//     channels; warp w computes tile row w: 32 pixels (two m16 tiles) x 64
//     channels. 8 x 32 tiles give 128 blocks at b2 x 128^2, one wave.
//   * The whole halo'd float32 tile does not fit beside the weights at
//     k = 13, so the 64 input channels go in two passes of 32: a pixel's 32
//     channels are one 128-byte row, chunk-swizzled as in the bfloat16
//     kernel ((8+k-1) x (32+k-1) rows: 80 KB at k = 9, 110 KB at k = 13).
//     The weights stream one tap (32 ci x 64 co, rows padded to 72 floats)
//     at a time through a ring of 3 cp.async stages.
//   * Rounding: the tensor cores ignore the low 13 bits of a .tf32 operand,
//     so an unrounded float32 would be truncated. cp.async copies bytes:
//     each thread rounds the 16-byte chunks it copied, in place, once they
//     have landed and before the barrier that publishes them (the tile once
//     a pass, the weights once a tap). The fragment loads read TF32 values.
//   * A (pixels x ci) by ldmatrix.x4 from the swizzled rows: 32-bit values
//     as pairs of 16-bit ones, so the non-transposing load gives the
//     row-major A fragment; a tap is another start row. B (ci x co, HWIO as
//     given: no repacking for the forward or the dgrad weights) by 32-bit
//     loads, conflict-free on the 72-float rows.
//   * The tensor cores' float32 sums are not IEEE adds (they truncate),
//     which would bias a long chain of products by up to ~0.5 ulp a step.
//     One kernel row's products (k taps x 32 channels: 4k mma) go into
//     fresh accumulators that are then added to the running sums by float32
//     adds: no chain runs longer than one kernel row. 128 accumulator
//     registers a thread, one block an SM.
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

// ---- TF32 entry: tensor cores, mma.sync m16n8k8 ----

constexpr int kTHt = 8;                    // output tile rows per block, one a warp
constexpr int kTWt = 32;                   // output tile columns per block (two m16 tiles)
constexpr int kCCt = 32;                   // input channels of a pass: one 128-byte row a pixel
constexpr int kWStagesT = 3;               // weight taps in shared memory
constexpr int kWRowT = 72;                 // floats a weight row (64 co + 8): conflict-free B loads
constexpr int kTapFloatsT = kCCt * kWRowT;

template <int K>
struct Tf32Tile {
  static constexpr int kInH = kTHt + K - 1;
  static constexpr int kInW = kTWt + K - 1;
  static constexpr int kInPix = kInH * kInW;
  static constexpr int kInBytes = kInPix * 128;
  static constexpr int kSmemBytes = kInBytes + kWStagesT * kTapFloatsT * 4;
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
conv_c64_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int H, int W) {
  using T = Tf32Tile<K>;
  constexpr int P = (K - 1) / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned xs = smem_u32(smem);                         // [kInPix][32 ci], swizzled
  float* const wsf = reinterpret_cast<float*>(smem + T::kInBytes);  // [stage][32 ci][kWRowT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // tile row
  const int g = lane >> 2;
  const int q = lane & 3;
  const int h0 = blockIdx.y * kTHt;
  const int w0 = blockIdx.x * kTWt;
  const float* xb = x + static_cast<size_t>(blockIdx.z) * H * W * kC;

  // The halo'd tile of channels ci0 .. ci0+31, zero outside the image; each
  // thread rounds the chunks it copied once they have landed.
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
  auto round_tile = [&]() {
    for (int i = tid; i < T::kInPix * 8; i += kThreads)
      round16_tf32(reinterpret_cast<float*>(smem + swz128(i >> 3, i & 7)));
  };
  // Tap `tap`'s weights for channels ci0 .. ci0+31: 32 rows of 64 co.
  auto load_tap = [&](int ci0, int tap) {
    const float* src = w + (static_cast<size_t>(tap) * kC + ci0) * kC;
    float* dst = wsf + (tap % kWStagesT) * kTapFloatsT;
    for (int i = tid; i < kCCt * 16; i += kThreads)
      cp_async16(smem_u32(dst + (i >> 4) * kWRowT + (i & 15) * 4), src + (i >> 4) * kC + (i & 15) * 4,
                 16);
  };
  auto round_tap = [&](int tap) {
    float* dst = wsf + (tap % kWStagesT) * kTapFloatsT;
    for (int i = tid; i < kCCt * 16; i += kThreads) round16_tf32(dst + (i >> 4) * kWRowT + (i & 15) * 4);
  };

  // acc[m][n]: pixels 16 m .. 16 m + 15 of tile row `warp` x output channels 8 n .. 8 n + 7.
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  // A: lane l addresses pixel (l & 7) + 8 ((l >> 3) & 1) of an m16 tile and
  // the 4-channel chunk 2 ks + (l >> 4) of the k step.
  const int apix = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int achunk = lane >> 4;

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int ci0 = pass * kCCt;
    if (pass) __syncthreads();  // every warp is done with the first pass's tile and weights
    // Group 0: the tile and tap 0; then one group a tap.
    load_tile(ci0);
    for (int t = 0; t < kWStagesT - 1; ++t) {
      load_tap(ci0, t);
      cp_async_commit();
    }
#pragma unroll 1
    for (int kh = 0; kh < K; ++kh) {
      // One kernel row's products, summed on the tensor cores.
      float part[2][8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[m][n][i] = 0.f;
#pragma unroll 1
      for (int kw = 0; kw < K; ++kw) {
        const int tap = kh * K + kw;
        cp_async_wait<kWStagesT - 2>();  // this tap (and, at tap 0, the tile) landed
        if (tap == 0) round_tile();
        round_tap(tap);
        __syncthreads();  // ... rounded, for all threads; and tap - 1's slot is free again
        if (tap + kWStagesT - 1 < K * K) load_tap(ci0, tap + kWStagesT - 1);
        cp_async_commit();  // possibly empty: keeps one group per tap
        const float* wt = wsf + (tap % kWStagesT) * kTapFloatsT;
        const int prow = (warp + kh) * T::kInW + kw + apix;
#pragma unroll
        for (int ks = 0; ks < kCCt / 8; ++ks) {
          unsigned b[8][2];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            b[n][0] = __float_as_uint(wt[(8 * ks + q) * kWRowT + 8 * n + g]);
            b[n][1] = __float_as_uint(wt[(8 * ks + q + 4) * kWRowT + 8 * n + g]);
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            unsigned a[4];
            ldsm_x4(a, xs + swz128(prow + 16 * m, 2 * ks + achunk));
#pragma unroll
            for (int n = 0; n < 8; ++n) mma_m16n8k8_tf32(part[m][n], a, b[n][0], b[n][1]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][n][i] += part[m][n][i];
    }
    cp_async_wait<0>();
  }

  // Epilogue: d[0], d[1] are pixel g, channels 2q and 2q + 1; d[2], d[3] pixel g + 8.
  const int oh = h0 + warp;
  if (oh >= H) return;
  float* yrow = y + (static_cast<size_t>(blockIdx.z) * H + oh) * W * kC;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = w0 + 16 * m + g + 8 * half;
      if (ow < W) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(yrow + static_cast<size_t>(ow) * kC + 8 * n + 2 * q) =
              make_float2(acc[m][n][2 * half], acc[m][n][2 * half + 1]);
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
