// Weight gradient of the stride-1 SAME k x k convolution, 64 -> 64 channels,
// float32 or bfloat16 in (and float32 at Cin -> 64 channels, the wide entry),
// float32 accumulation and out: the backward pass of the DecompositionNet's
// 9x9 shallow conv for its weights.
//
// Replaces: sshslie_tpu/ops/conv_pallas.py::conv9_wgrad (Pallas kernel
// _wgrad_kernel). Same function:
//   dw[kh,kw,ci,co] = sum_{b,h,w} xpad[b,h+kh,w+kw,ci] * dy[b,h,w,co],
// NHWC x NHWC -> HWIO. The TPU kernel sums every grid step into one
// VMEM-resident output over a sequential grid; Hopper's blocks run in
// parallel and in no order, so that does not carry over. Nor do the width
// pairing to 128 lanes and the W % 128 gate: any B, H, W works here.
//
// float32 entry (sshslie_conv9_wgrad_f32). What bounds it on an H100:
// arithmetic. At the training shape (2, 128, 128, 64), k = 9, it is
// 2*32768*81*64*64 = 2.17e10 FLOP against ~18 MB in and out, so ~1200 FLOP a
// byte; float32 outside the tensor cores (full float32) peaks at 67
// TFLOP/s: 0.32 ms, against ~5 us for the bytes.
//
// Design, a split-K reduction over the B*H*W pixels on the CUDA cores:
//   * Block (slice s, input-channel chunk, kernel row kh) owns the outputs
//     dw[kh, 0..k-1, 16 ci, 64 co] and sums them over its slice s of the
//     B*H image rows. A thread keeps k taps x 4 output channels of one input
//     channel (36 registers at k = 9) and walks every pixel of the slice.
//   * Per image row, 64 pixels at a time, the block stages the dY segment
//     (64 px x 64 co) and the halo'd input segment (64+k-1 px x 16 ci, zero
//     outside the image) in shared memory. A thread loads 8+k-1 inputs of its
//     channel into registers once and reuses them for all k taps of 8 pixels:
//     per pixel one float4 of dY (conflict-free, broadcast over the two input
//     channels of a warp) for 4k FMA.
//   * Rows whose input row kh lands in the zero padding add nothing and are
//     skipped.
//   * Each block writes its partial sums to a scratch buffer (splits x k x k x
//     64 x 64, allocated by the wrapper); a second kernel adds the partials in
//     slice order. No float atomics, so the result is the same from run to
//     run. The number of slices fills the card's resident blocks once.
// No tensor cores, TMA or pipelining yet: a right first kernel. The wide
// entry (sshslie_conv9_wgrad_wide_f32) runs the same kernel, blocks and sums
// over Cin input channels, a multiple of 32 up to 256 (224 for 224-band
// cubes), with 64 output channels: wgrad_c64_kernel<K, 0> reads Cin from its
// grid (Cin / 16 chunks a kernel row, so at Cin = 224 a slice is 126 blocks
// and the card's one wave holds 2 slices), and wgrad_reduce_kernel sums its
// partials; the 64-channel instantiation, wgrad_c64_kernel<K, 64>, compiles
// to the code it had before the template.
//
// bfloat16 entry (sshslie_conv9_wgrad_bf16): bfloat16 x and dY, float32
// sums, partials and dW (conv_pallas.py::conv9_wgrad on bfloat16 operands).
// What bounds it: at the bf16 training shape (8, 128, 128, 64), k = 9, the
// 8.7e10 FLOP take 0.088 ms on the tensor cores (989 TFLOP/s), against
// ~0.02 ms for the bytes; every block reads its slice's dY and X from L2.
// Design, per tap a GEMM dW_tap^T (64 co x 64 ci) = dY^T (64 x P) X_tap
// (P x 64) as wgmma, split over the P = B*H*W pixels:
//   * Block (slice s, kernel row kh, tap group) owns the taps of row kh: the
//     whole row up to k = 9, half of it above. Its warpgroups own 3 taps
//     each (3 warpgroups, one block an SM, at k = 9), 3 x 32 float32
//     accumulators a thread. Every warpgroup issues all 3 taps' wgmma: a
//     wgmma under a run-time test is serialized by ptxas, so a tap past the
//     block's (k = 5, 7, 11, 13) is computed from padding rows and not
//     stored.
//   * Per image row of the slice, 64 pixels at a time, the block stages the
//     dY segment (64 px x 64 co) and the halo'd input segment (64+k-1 px x
//     64 ci, zero outside the image by cp.async src-size 0) in bfloat16, 128
//     bytes a pixel, chunk-swizzled (mma.cuh), through a ring of 4 stages:
//     two landing while the tensor cores run the other two. One
//     __syncthreads a segment.
//   * A, dY^T, goes to registers by ldmatrix.x4.trans (warp w: output
//     channels 16w .. 16w+15), once a segment for all taps of the
//     warpgroup. B, X shifted by the tap, is read by wgmma m64n64k16 from
//     the [px][ci] rows (MN-major) through a descriptor that starts at the
//     tap's row. A segment's wgmma are committed as one group; A is
//     double-buffered in registers.
//   * Rows whose input row lands in the zero padding are skipped, partials
//     go to the scratch buffer and the second kernel sums them in slice
//     order, as in the float32 entry: repeats are bit-identical. The wrapper
//     picks the slice count (ops/conv9.py::conv9_wgrad_bf16_splits) to fill
//     one wave of resident blocks (sshslie_conv9_wgrad_resident_bf16).
//   * L2 traffic: every (kh, tap group) reads all of x and dY once, k times
//     the 33.5 MB of operands at b8 x 128^2 and k = 9: 0.3 GB.
//
// TF32 entry (sshslie_conv9_wgrad_tf32): float32 x and dY, each operand
// rounded to TF32 (cvt.rna), products on the tensor cores, float32 sums,
// partials and dW (conv_pallas.py::conv9_wgrad under matmul_precision
// tensorfloat32). What bounds it: the 2.17e10 FLOP at the training shape
// (2, 128, 128, 64), k = 9, at the dense TF32 rate (495 TFLOP/s): 0.0439
// ms, against ~0.01 ms for the float32 bytes. Per tap a GEMM dW_tap^T (64 co
// x 64 ci) = dY^T (64 x P) X_tap (P x 64) over the P = B*H*W pixels, split
// into slices, on wgmma m64n64k8 .tf32 (the form of mma.cuh, checked by
// tools/tc_probe and the lane-level model tests/test_torch_wgrad_fragments.py):
//   * .tf32 wgmma reads B K-major only, and a descriptor moves in 16-byte
//     steps. A is dY^T from registers, loaded once a 64-pixel segment and
//     shared by every tap. B is X^T, the tap's one-pixel shift in the
//     descriptor: four phase copies of X^T without swizzle (copy c holds
//     pixels c, c + 1, ...), tap 4 a + c reading copy c from pixel 4 a.
//   * Block (slice s, kernel row kh, tap group) of two warpgroups owns the
//     whole kernel row up to k = 9 (half of it above): warpgroup 0 computes
//     5 taps and warpgroup 1 4 at k = 9, 5 x 32 running sums in registers
//     (248 registers, no spills), one block an SM. The block stages each
//     segment once for all 9 taps, so x and dY are read from L2 9 times.
//   * Each tap's segment (8 k steps) goes into fresh accumulators, the first
//     wgmma with scale-d false; then the tap's running sums += them by
//     float32 adds: no chain of the tensor cores' truncating adds runs
//     longer than one segment.
//   * Staging, a ring of two: warpgroup 0 issues cp.async of X two segments
//     ahead and of dY one ahead (72-float rows); warpgroup 1 rounds the next
//     segment's X once (cvt.rna) into the phase copies, a part while each of
//     its taps runs; dY is rounded as its A fragments load. One fence and
//     __syncthreads a segment.
//   * Rows whose input row lands in the zero padding are skipped, partials
//     go to the scratch buffer and wgrad_reduce_kernel sums them in slice
//     order, as in the other entries: repeats are bit-identical. The slice
//     count fills one wave of resident blocks
//     (sshslie_conv9_wgrad_splits_tf32).
//   * Measured on an H100 (tools/conv_bench, PERF.md, PR 12): 0.107 ms at
//     (2, 128, 128, 64), k = 9 (41% of the bound; cuDNN's TF32 call 0.38),
//     from 0.272 on mma.sync. The partial stores and the second kernel take
//     ~0.016 ms of it. In the loop the tensor cores run about half the
//     time, shared memory (B's 144 KB an item, the staging ~170 KB) a
//     little more. Tried and dropped: A = X shifted by the tap with B = dY
//     transposed (0.155: the per-tap A loads and their rounding), a bulk
//     copy of X (slower), the partials staged for coalesced stores, dY
//     rounded in place, the conversion staggered before the taps, double
//     fresh accumulators in warpgroup 1 (~1%).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kC = 64;         // input and output channels
constexpr int kCiB = 16;       // input channels a block owns
constexpr int kTP = 64;        // pixels of a row staged at a time
constexpr int kSeg = 8;        // pixels a thread walks with one register window
constexpr int kThreads = 256;  // float32: 16 input channels x 16 groups of 4 outputs

template <int K>
struct WTile {
  static constexpr int kInW = kTP + K - 1;
  static constexpr int kInWPad = kInW | 1;  // odd row stride: fewer bank conflicts
};

// CIN input channels (x's pixel stride); CIN = 0: the wide entry's,
// gridDim.y * kCiB of them (a multiple of 32 up to 256).
template <int K, int CIN>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_c64_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 float* __restrict__ part, int B, int H, int W, int splits) {
  using T = WTile<K>;
  constexpr int P = (K - 1) / 2;
  const int cin = CIN > 0 ? CIN : static_cast<int>(gridDim.y) * kCiB;
  __shared__ float xs[kCiB][T::kInWPad];         // input segment, 16 ci
  __shared__ __align__(16) float ds[kTP][kC];    // dY segment, 64 co

  const int tid = threadIdx.x;
  const int cog = tid & 15;   // output channels 4*cog .. 4*cog+3
  const int cil = tid >> 4;   // input channel ci0 + cil
  const int s = blockIdx.x;
  const int ci0 = blockIdx.y * kCiB;
  const int kh = blockIdx.z;
  const long long rows = static_cast<long long>(B) * H;
  const int r0 = static_cast<int>(rows * s / splits);
  const int r1 = static_cast<int>(rows * (s + 1) / splits);

  float acc[K][4];
#pragma unroll
  for (int kw = 0; kw < K; ++kw)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[kw][c] = 0.f;

  for (int r = r0; r < r1; ++r) {
    const int b = r / H;
    const int h = r - b * H;
    const int hx = h + kh - P;  // the input row kernel row kh reads
    if (hx < 0 || hx >= H) continue;  // zero padding: the same for the whole block
    const float* xrow = x + (static_cast<size_t>(b) * H + hx) * W * cin;
    const float* drow = dy + (static_cast<size_t>(b) * H + h) * W * kC;
    for (int w0 = 0; w0 < W; w0 += kTP) {
      __syncthreads();  // the previous segment is consumed
      for (int i = tid; i < kTP * (kC / 4); i += kThreads) {
        const int px = i / (kC / 4);
        const int q = i % (kC / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (w0 + px < W)
          v = load4(drow + static_cast<size_t>(w0 + px) * kC + q * 4);
        *reinterpret_cast<float4*>(&ds[px][q * 4]) = v;
      }
      for (int i = tid; i < T::kInW * (kCiB / 4); i += kThreads) {
        const int px = i / (kCiB / 4);
        const int q = i % (kCiB / 4);
        const int gw = w0 - P + px;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gw >= 0 && gw < W)
          v = load4(xrow + static_cast<size_t>(gw) * cin + ci0 + q * 4);
        xs[q * 4 + 0][px] = v.x;
        xs[q * 4 + 1][px] = v.y;
        xs[q * 4 + 2][px] = v.z;
        xs[q * 4 + 3][px] = v.w;
      }
      __syncthreads();

      const int npx = min(kTP, W - w0);  // dY past W is zero: whole segments are safe
#pragma unroll 1
      for (int j0 = 0; j0 < npx; j0 += kSeg) {
        float xr[kSeg + K - 1];
#pragma unroll
        for (int t = 0; t < kSeg + K - 1; ++t) xr[t] = xs[cil][j0 + t];
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
          const float4 d = *reinterpret_cast<const float4*>(&ds[j0 + j][cog * 4]);
#pragma unroll
          for (int kw = 0; kw < K; ++kw) {
            const float xv = xr[j + kw];
            acc[kw][0] = fmaf(xv, d.x, acc[kw][0]);
            acc[kw][1] = fmaf(xv, d.y, acc[kw][1]);
            acc[kw][2] = fmaf(xv, d.z, acc[kw][2]);
            acc[kw][3] = fmaf(xv, d.w, acc[kw][3]);
          }
        }
      }
    }
  }

  // Partial of slice s: part[s][kh][kw][ci][co].
  float* out = part + static_cast<size_t>(s) * K * K * cin * kC;
#pragma unroll
  for (int kw = 0; kw < K; ++kw) {
    float* o = out + ((static_cast<size_t>(kh) * K + kw) * cin + ci0 + cil) * kC + cog * 4;
    *reinterpret_cast<float4*>(o) = make_float4(acc[kw][0], acc[kw][1], acc[kw][2], acc[kw][3]);
  }
}

// dw[i] = sum over s = 0..splits-1 of part[s][i], in that order.
__global__ void wgrad_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dw,
                                    int n4, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 a = part[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = part[static_cast<size_t>(s) * n4 + i];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    dw[i] = a;
  }
}

// ---- bfloat16 entry: tensor cores ----

constexpr int kSegTc = 64;     // pixels of a row staged at a time
constexpr int kStagesTc = 4;   // segments in shared memory: two loading, two being read
constexpr int kWgTaps = 3;     // taps a warpgroup owns

template <int K>
struct TcWTile {
  // Taps of one kernel row a block owns: the whole row up to k = 9; above
  // it, half a row, so that the accumulators fit the registers. Warpgroup
  // i takes taps 3i .. 3i+2 of them; every warpgroup runs all 3 (wgmma
  // under a run-time test is serialized), and a tap past the block's is
  // computed from padding rows and not stored.
  static constexpr int kTaps = K <= 9 ? K : (K + 1) / 2;
  static constexpr int kGroups = (K + kTaps - 1) / kTaps;
  static constexpr int kWgs = (kTaps + kWgTaps - 1) / kWgTaps;
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kInW = kSegTc + K - 1;  // X rows loaded a segment
  // X rows read: up to the last group's last warpgroup's last tap.
  static constexpr int kXRows = kSegTc + (kGroups - 1) * kTaps + kWgs * kWgTaps - 1;
  static constexpr int kDyBytes = kSegTc * kC * 2;
  // Stages start on the swizzle pattern's 1024-byte period (wgmma reads X).
  static constexpr int kStageBytes = (kDyBytes + kXRows * kC * 2 + 1023) / 1024 * 1024;
  static constexpr int kSmemBytes = 1024 + kStagesTc * kStageBytes;
  static_assert(kXRows >= kInW, "the X rows loaded fit the stage");
};

template <int K>
__global__ void __launch_bounds__(TcWTile<K>::kThreads, 1)
wgrad_c64_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                      float* __restrict__ part, int B, int H, int W, int splits) {
  using T = TcWTile<K>;
  constexpr int P = (K - 1) / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned base = (smem_u32(smem) + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;        // warpgroup
  const int wq = (tid >> 5) & 3;  // warp of the warpgroup: output channels 16 wq .. 16 wq + 15
  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int kw0 = blockIdx.z * T::kTaps + wg * kWgTaps;  // this warpgroup's first tap
  // Taps kw0 .. kw0 + ntaps - 1 are the block's (ntaps may be 0).
  const int ntaps = max(0, min(kWgTaps, min(K, (blockIdx.z + 1) * T::kTaps) - kw0));
  const long long rows = static_cast<long long>(B) * H;
  const int r0 = static_cast<int>(rows * s / splits);
  const int r1 = static_cast<int>(rows * (s + 1) / splits);
  const int nseg = (W + kSegTc - 1) / kSegTc;

  // Rows whose input row kh lands in the zero padding add nothing.
  auto valid = [&](int r) {
    const int hx = r % H + kh - P;
    return hx >= 0 && hx < H;
  };
  int items = 0;  // (row, segment) pairs of the slice to sum
  for (int r = r0; r < r1; ++r) items += valid(r);
  items *= nseg;

  // The load cursor: the next (row, segment) to stage.
  int lr = r0;
  while (lr < r1 && !valid(lr)) ++lr;
  int lseg = 0;
  // Stage the cursor's segment into slot st (dY, and X zero outside the
  // image) and advance the cursor; past the slice's end, nothing.
  auto load_next = [&](int st) {
    if (lr >= r1) return;
    const int b = lr / H;
    const int h = lr - b * H;
    const int w0 = lseg * kSegTc;
    const __nv_bfloat16* drow = dy + (static_cast<size_t>(b) * H + h) * W * kC;
    const __nv_bfloat16* xrow = x + (static_cast<size_t>(b) * H + h + kh - P) * W * kC;
    const unsigned ds = base + st * T::kStageBytes;
    for (int i = tid; i < (kSegTc + T::kInW) * 8; i += T::kThreads) {
      const int p = i >> 3;
      const int c = i & 7;
      if (p < kSegTc) {
        const bool in = w0 + p < W;
        cp_async16(ds + swz128(p, c), in ? drow + static_cast<size_t>(w0 + p) * kC + c * 8 : dy,
                   in ? 16 : 0);
      } else {
        const int q = p - kSegTc;
        const int gw = w0 - P + q;
        const bool in = gw >= 0 && gw < W;
        cp_async16(ds + T::kDyBytes + swz128(q, c),
                   in ? xrow + static_cast<size_t>(gw) * kC + c * 8 : x, in ? 16 : 0);
      }
    }
    if (++lseg == nseg) {
      lseg = 0;
      do ++lr; while (lr < r1 && !valid(lr));
    }
  };

  // acc[t]: dW of tap kw0 + t transposed, output channels (M) x input
  // channels (N), 64 x 64.
  float acc[kWgTaps][32];
#pragma unroll
  for (int t = 0; t < kWgTaps; ++t)
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[t][c] = 0.f;

  // A, dY^T (co x px), by ldmatrix.x4.trans from the [px][co] rows: lane l
  // addresses pixel row (l & 7) + 8 (l >> 4) of the 16-pixel k step and the
  // co chunk 2 wq + ((l >> 3) & 1). B, X (px x ci) shifted by the tap: 16
  // pixel rows from row 16 ks + kw, read by wgmma from shared memory.
  const int arow = (lane & 7) + ((lane >> 4) << 3);
  const int achunk = 2 * wq + ((lane >> 3) & 1);
  unsigned a[2][4][4];  // two segments of A fragments: one being read by wgmma, one being loaded

  // One segment: its dY fragments into a[par], then 4 k steps x 3 taps of
  // wgmma, committed as one group.
  auto run_segment = [&](int it, auto par_tag) {
    constexpr int par = decltype(par_tag)::value;
    wgmma_wait<1>();  // segment it - 2's products are done: its slot and a[par] are free
    cp_async_wait<1>();  // segment it landed
    fence_proxy_async();  // ... and is visible to wgmma
    __syncthreads();      // ... for all threads; and every warpgroup is done with it - 2
    load_next((it + 2) % kStagesTc);
    cp_async_commit();  // possibly empty: keeps one group per segment
    const unsigned ds = base + (it % kStagesTc) * T::kStageBytes;
#pragma unroll
    for (int ks = 0; ks < kSegTc / 16; ++ks)
      ldsm_x4_trans(a[par][ks], ds + swz128(ks * 16 + arow, achunk));
    wgmma_fence();
    const unsigned long long dx = wgmma_desc(ds + T::kDyBytes + kw0 * 128);
#pragma unroll
    for (int ks = 0; ks < kSegTc / 16; ++ks)
#pragma unroll
      for (int t = 0; t < kWgTaps; ++t)
        wgmma_m64n64k16<1>(acc[t], a[par][ks], dx + (((ks * 16 + t) * 128) >> 4));
    wgmma_commit();
  };

  for (int st = 0; st < 2; ++st) {
    load_next(st);
    cp_async_commit();  // possibly empty: keeps one group per segment
  }
#pragma unroll 1
  for (int it = 0; it < items; it += 2) {
    run_segment(it, std::integral_constant<int, 0>());
    if (it + 1 < items) run_segment(it + 1, std::integral_constant<int, 1>());
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // Partial of slice s: part[s][kh][kw][ci][co].
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int t = 0; t < kWgTaps; ++t) {
    if (t >= ntaps) break;
    float* out = part + ((static_cast<size_t>(s) * K + kh) * K + kw0 + t) * kC * kC;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int co = 16 * wq + g + 8 * ((i >> 1) & 1);
      const int ci = 8 * (i >> 2) + 2 * q + (i & 1);
      out[ci * kC + co] = acc[t][i];
    }
  }
}

// ---- TF32 entry: tensor cores, wgmma m64n64k8 ----

constexpr int kSegT = 64;                // pixels of a row a segment: one chain of products
constexpr int kWgsT = 2;                 // warpgroups a block
constexpr int kThreadsT = 128 * kWgsT;
constexpr int kRowT = 72;                // floats a landed pixel (X or dY): 64 channels + 8

template <int K>
struct Tf32WTile {
  // Blocks a kernel row, and taps warpgroups 0 and 1 of a block compute: the
  // whole row up to k = 9, 5 + 4 taps at k = 9; half of it above, so that
  // the running sums fit the registers. At k = 3, and above 9, both take T
  // = ceil(k / 2 groups) taps, the last warpgroup the T that end at k (a
  // tap may be computed twice and is stored once).
  static constexpr int kGroups = K <= 9 ? 1 : 2;
  static constexpr bool kSplit = kGroups == 1 && K >= 5;
  static constexpr int kTapsWg = (K + kWgsT * kGroups - 1) / (kWgsT * kGroups);
  static constexpr int kTaps0 = kSplit ? (K + 1) / 2 : kTapsWg;
  static constexpr int kTaps1 = kSplit ? K / 2 : kTapsWg;
  static constexpr int kTaps = kTaps0 + kTaps1;                 // taps of the block's window
  static constexpr int kXRows = kSegT + kTaps - 1;              // X pixels a segment
  static constexpr int kXtPix = kSegT + 4 * ((kTaps - 1) / 4);  // pixels of a phase copy
  static constexpr int kXtSbo = kXtPix * 32;                    // bytes of 8 channels of a copy
  static constexpr int kXtBytes = 4 * 8 * kXtSbo;               // the four phase copies of X^T
  static constexpr int kRawBytes = kXRows * kRowT * 4;
  static constexpr int kDyBytes = kSegT * kRowT * 4;
  // Two buffers of each: one read while the next lands or is converted.
  static constexpr int kSmemBytes = 2 * (kXtBytes + kRawBytes + kDyBytes);
};

// First tap warpgroup u (0 .. 2 kGroups - 1) computes, and the first it
// stores (the taps below are another warpgroup's).
template <int K>
__device__ __forceinline__ int tf32_first_tap(int u) {
  using T = Tf32WTile<K>;
  if (T::kSplit) return u * T::kTaps0;
  return min(u * T::kTapsWg, K - T::kTapsWg);
}

template <int K>
__device__ __forceinline__ int tf32_first_stored(int u) {
  using T = Tf32WTile<K>;
  return T::kSplit ? u * T::kTaps0 : u * T::kTapsWg;
}

template <int K>
__global__ void __launch_bounds__(kThreadsT, 1)
wgrad_c64_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      float* __restrict__ part, int B, int H, int W, int splits) {
  using T = Tf32WTile<K>;
  constexpr int P = (K - 1) / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  // [buffer]: X^T phase copies, then landed X pixel rows, then landed dY pixel rows.
  auto raw_ptr = [&](int buf) {
    return reinterpret_cast<float*>(smem + 2 * T::kXtBytes + buf * T::kRawBytes);
  };
  auto dy_ptr = [&](int buf) {
    return reinterpret_cast<float*>(smem + 2 * (T::kXtBytes + T::kRawBytes) + buf * T::kDyBytes);
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warpgroup (warp-uniform)
  const int wq = (tid >> 5) & 3;   // warp of the warpgroup: output channels 16 wq .. 16 wq + 15
  const int g = lane >> 2;
  const int q = lane & 3;
  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int u = blockIdx.z * kWgsT + wg;
  const int kwb = tf32_first_tap<K>(blockIdx.z * kWgsT);  // the block's first tap: X pixel 0
  const int kw0 = tf32_first_tap<K>(u);                   // this warpgroup's first tap
  const long long rows = static_cast<long long>(B) * H;
  const int r0 = static_cast<int>(rows * s / splits);
  const int r1 = static_cast<int>(rows * (s + 1) / splits);
  const int nseg = (W + kSegT - 1) / kSegT;

  // Rows whose input row kh lands in the zero padding add nothing.
  auto valid = [&](int r) {
    const int hx = r % H + kh - P;
    return hx >= 0 && hx < H;
  };
  int items = 0;  // (row, segment) pairs of the slice to sum
  for (int r = r0; r < r1; ++r) items += valid(r);
  items *= nseg;

  // Load cursors over the slice's (row, segment) pairs: X lands two items
  // ahead of the one being summed (then is converted), dY one.
  struct Cursor {
    int r, seg;
  };
  Cursor cx{r0, 0};
  while (cx.r < r1 && !valid(cx.r)) ++cx.r;
  Cursor cd = cx;
  auto advance = [&](Cursor& c) {
    if (++c.seg == nseg) {
      c.seg = 0;
      do ++c.r; while (c.r < r1 && !valid(c.r));
    }
  };
  // Warpgroup 0 (it computes the more taps) issues the loads: a thread
  // copies the 16-byte chunk ch of pixels p0, p0 + 8, ...
  const int ch = tid & 15;
  const int p0 = (tid >> 4) & 7;
  // X pixels w0 - P + kwb .. + kXRows - 1 of input row r + kh - P as they
  // lie, into buffer buf, zero outside the image; then the cursor moves on.
  auto load_x = [&](Cursor& c, int buf) {
    if (c.r >= r1) return;
    const int gw0 = c.seg * kSegT - P + kwb + p0;
    const float* src = x + (static_cast<long long>(c.r + kh - P) * W + gw0) * kC + ch * 4;
    const unsigned dst = smem_u32(raw_ptr(buf)) + (p0 * kRowT + ch * 4) * 4;
#pragma unroll
    for (int n = 0; n < (T::kXRows + 7) / 8; ++n) {
      const int gw = gw0 + 8 * n;
      const bool in = gw >= 0 && gw < W;
      if (8 * n + p0 < T::kXRows)
        cp_async16(dst + 8 * n * kRowT * 4, in ? src + 8 * n * kC : x, in ? 16 : 0);
    }
    advance(c);
  };
  // dY pixels w0 .. w0 + 63 of row r as they lie, zero past W.
  auto load_dy = [&](Cursor& c, int buf) {
    if (c.r >= r1) return;
    const int w = c.seg * kSegT + p0;
    const float* src = dy + (static_cast<long long>(c.r) * W + w) * kC + ch * 4;
    const unsigned dst = smem_u32(dy_ptr(buf)) + (p0 * kRowT + ch * 4) * 4;
#pragma unroll
    for (int n = 0; n < kSegT / 8; ++n) {
      const bool in = w + 8 * n < W;
      cp_async16(dst + 8 * n * kRowT * 4, in ? src + 8 * n * kC : dy, in ? 16 : 0);
    }
    advance(c);
  };
  // Part `part` of `parts` of buffer buf's landed X into its X^T phase
  // copies, by warpgroup 1 (it computes the fewer taps). A warp takes pixels
  // 4 J .. 4 J + 6 of 32 channels, a channel a lane (conflict-free loads
  // from the 72-float rows), rounds them to TF32 once and stores 4 pixels
  // of its channel into each copy, 16 bytes: pixel p goes to pixel p - c of
  // copy c, and 8 lanes fill one core matrix.
  auto convert_x = [&](int buf, int part, int parts) {
    constexpr int kTasks = T::kXtPix / 4 * 2;  // (core matrix column, 32 channels)
    const int per = (kTasks + parts - 1) / parts;
    const int end = min(kTasks, (part + 1) * per);
    const float* raw = raw_ptr(buf) + lane;
    unsigned char* xt = smem + buf * T::kXtBytes + (lane & 7) * 16;
    for (int task = part * per + wq; task < end; task += 4) {
      const int J = task >> 1;
      const int ci = (task & 1) * 32;
      float v[7];
#pragma unroll
      for (int e = 0; e < 7; ++e) v[e] = tf32_rna(raw[min(4 * J + e, T::kXRows - 1) * kRowT + ci]);
      unsigned char* d = xt + ((ci + lane) >> 3) * T::kXtSbo + J * 128;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(d + c * 8 * T::kXtSbo) = make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
    }
  };

  const int aoff = q * kRowT + 16 * wq + g;
  // Prologue: items 0 and 1's X and item 0's dY land; item 0's X is converted.
  if (wg == 0) {
    load_x(cx, 0);
    load_x(cx, 1);
    load_dy(cd, 0);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  if (wg == 1) convert_x(0, 0, 1);

  // The warpgroup's kTapsHere taps over the slice's items, then its partial.
  auto run = [&](auto taps_tag) {
    constexpr int kTapsHere = decltype(taps_tag)::value;
    // acc[t]: the running sums of tap kw0 + t, output channels (M) x input
    // channels (N); fresh: one tap's products of the current segment.
    float acc[kTapsHere][32];
    float fresh[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) fresh[i] = 0.f;
#pragma unroll
    for (int t = 0; t < kTapsHere; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
    unsigned a[kSegT / 8][4];  // A, dY^T of the segment: every tap's

#pragma unroll 1
    for (int it = 0; it < items; ++it) {
      const int buf = it & 1;
      cp_async_wait<0>();   // item it's dY and item it + 1's X landed (warpgroup 0's copies)
      fence_proxy_async();  // item it's X^T, stored by this thread, is visible to wgmma
      __syncthreads();      // ... for all threads; and every warpgroup is done with item it - 1
      const float* ds = dy_ptr(buf) + aoff;
#pragma unroll
      for (int ks = 0; ks < kSegT / 8; ++ks) rows_fragment_tf32<kRowT>(a[ks], ds, 8 * ks);
      const unsigned xt = smem_u32(smem) + buf * T::kXtBytes;
      // Per tap, 8 k steps of wgmma into fresh accumulators, the first with
      // scale-d false; while they run, warpgroup 0 issues the loads (tap 0)
      // and warpgroup 1 converts the next item's X^T (a part a tap); then
      // the tap's sums += them, so no chain of the tensor cores'
      // truncating adds runs past the segment.
#pragma unroll
      for (int t = 0; t < kTapsHere; ++t) {
        const int r = kw0 - kwb + t;  // the tap's offset in the window: copy r % 4, pixel 4 (r / 4)
        const unsigned long long desc =
            xt_desc(xt + (r & 3) * 8 * T::kXtSbo + (r >> 2) * 128, T::kXtSbo);
        wgmma_fence();
        wgmma_m64n64k8_tf32_first(fresh, a[0], desc);
#pragma unroll
        for (int ks = 1; ks < kSegT / 8; ++ks)
          wgmma_m64n64k8_tf32(fresh, a[ks], desc + ((ks * 256) >> 4));
        wgmma_commit();
        if (wg == 0 && t == 0) {
          load_x(cx, buf);       // item it + 2
          load_dy(cd, buf ^ 1);  // item it + 1
          cp_async_commit();
        }
        if (wg == 1 && t < T::kTaps1 && it + 1 < items)
          convert_x(buf ^ 1, t, T::kTaps1);  // item it + 1
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[t][i] += fresh[i];
      }
    }
    cp_async_wait<0>();

    // Partial of slice s: part[s][kh][kw][ci][co]; acc[t][i] is output
    // channel 16 wq + g + 8 ((i >> 1) & 1), input channel 8 (i >> 2) + 2 q
    // + (i & 1).
    float* out = part + ((static_cast<size_t>(s) * K + kh) * K) * kC * kC;
    const int stored = tf32_first_stored<K>(u);
#pragma unroll
    for (int t = 0; t < kTapsHere; ++t) {
      const int kw = kw0 + t;
      if (kw < stored) continue;
      float* o = out + static_cast<size_t>(kw) * kC * kC + (2 * q) * kC + 16 * wq + g;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[(8 * (i >> 2) + (i & 1)) * kC + 8 * ((i >> 1) & 1)] = acc[t][i];
    }
  };
  if (wg == 0)
    run(std::integral_constant<int, T::kTaps0>());
  else
    run(std::integral_constant<int, T::kTaps1>());
}

// Slices of the float32 kernel over cin input channels (CIN, or the wide
// entry's cin where CIN is 0); at least 1, at most one image row a slice.
template <int K, int CIN = kC>
int splits_for(int B, int H, int cin = CIN) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgrad_c64_kernel<K, CIN>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  // One wave of resident blocks: (cin / kCiB) * K blocks a slice.
  const long long capacity = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long splits = capacity / ((cin / kCiB) * K);
  const long long rows = static_cast<long long>(B) * H;
  if (splits > rows) splits = rows;
  return static_cast<int>(splits < 1 ? 1 : splits);
}

// Blocks of the bfloat16 kernel the card holds at once.
template <int K>
int resident_bf16() {
  using T = TcWTile<K>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(wgrad_c64_bf16_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgrad_c64_bf16_kernel<K>,
                                                        T::kThreads, T::kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Slices of the TF32 kernel: one wave of its resident blocks, K * kGroups
// blocks a slice; at least 1, at most one image row a slice.
template <int K>
int splits_tf32(int B, int H) {
  using T = Tf32WTile<K>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(wgrad_c64_tf32_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgrad_c64_tf32_kernel<K>,
                                                        kThreadsT, T::kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long long capacity = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long splits = capacity / (K * T::kGroups);
  const long long rows = static_cast<long long>(B) * H;
  if (splits > rows) splits = rows;
  return static_cast<int>(splits < 1 ? 1 : splits);
}

int reduce(const float* part, float* dw, int K, int splits, cudaStream_t stream, int cin = kC) {
  const int n4 = K * K * cin * kC / 4;
  const int blocks = (n4 + 255) / 256;
  wgrad_reduce_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                                  reinterpret_cast<float4*>(dw), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const float* x, const float* dy, float* part, float* dw, int B, int H, int W,
           int splits, cudaStream_t stream) {
  const dim3 grid(splits, kC / kCiB, K);
  wgrad_c64_kernel<K, kC><<<grid, kThreads, 0, stream>>>(x, dy, part, B, H, W, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(part, dw, K, splits, stream);
}

template <int K>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* dy, float* part, float* dw, int B,
           int H, int W, int splits, cudaStream_t stream) {
  using T = TcWTile<K>;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_c64_bf16_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, K, T::kGroups);
  wgrad_c64_bf16_kernel<K><<<grid, T::kThreads, T::kSmemBytes, stream>>>(x, dy, part, B, H, W,
                                                                         splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(part, dw, K, splits, stream);
}

template <int K>
int launch_tf32(const float* x, const float* dy, float* part, float* dw, int B, int H, int W,
                int splits, cudaStream_t stream) {
  using T = Tf32WTile<K>;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_c64_tf32_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, K, T::kGroups);
  wgrad_c64_tf32_kernel<K><<<grid, kThreadsT, T::kSmemBytes, stream>>>(x, dy, part, B, H, W,
                                                                       splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(part, dw, K, splits, stream);
}

template <class E>
int wgrad_entry(const void* x, const void* dy, void* part, void* dw, int B, int H, int W, int K,
                int splits, void* stream) {
  const E* xe = static_cast<const E*>(x);
  const E* de = static_cast<const E*>(dy);
  float* pf = static_cast<float*>(part);
  float* wf = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 3: return launch<3>(xe, de, pf, wf, B, H, W, splits, s);
    case 5: return launch<5>(xe, de, pf, wf, B, H, W, splits, s);
    case 7: return launch<7>(xe, de, pf, wf, B, H, W, splits, s);
    case 9: return launch<9>(xe, de, pf, wf, B, H, W, splits, s);
    case 11: return launch<11>(xe, de, pf, wf, B, H, W, splits, s);
    case 13: return launch<13>(xe, de, pf, wf, B, H, W, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(std::integral_constant<int, K>()) for a runtime K the kernels take, or
// cudaErrorInvalidValue.
template <class F>
int with_k(int K, F&& f) {
  switch (K) {
    case 3: return f(std::integral_constant<int, 3>());
    case 5: return f(std::integral_constant<int, 5>());
    case 7: return f(std::integral_constant<int, 7>());
    case 9: return f(std::integral_constant<int, 9>());
    case 11: return f(std::integral_constant<int, 11>());
    case 13: return f(std::integral_constant<int, 13>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool wide_channels(int cin) { return cin >= 32 && cin <= 256 && cin % 32 == 0; }

template <int K>
int launch_wide(const float* x, const float* dy, float* part, float* dw, int B, int H, int W,
                int cin, int splits, cudaStream_t stream) {
  const dim3 grid(splits, cin / kCiB, K);
  wgrad_c64_kernel<K, 0><<<grid, kThreads, 0, stream>>>(x, dy, part, B, H, W, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(part, dw, K, splits, stream, cin);
}

}  // namespace

// How many pixel-row slices sshslie_conv9_wgrad_f32 splits the reduction
// into, for this card: the wrapper allocates splits*K*K*64*64 floats of
// scratch. Returns a negative CUDA error code on failure (-1 for a K the
// kernel does not take).
SSHSLIE_EXPORT int sshslie_conv9_wgrad_splits(int B, int H, int K) {
  switch (K) {
    case 3: return splits_for<3>(B, H);
    case 5: return splits_for<5>(B, H);
    case 7: return splits_for<7>(B, H);
    case 9: return splits_for<9>(B, H);
    case 11: return splits_for<11>(B, H);
    case 13: return splits_for<13>(B, H);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many blocks of sshslie_conv9_wgrad_bf16's kernel this card holds at
// once (one wave); the wrapper derives the slice count from it
// (ops/conv9.py::conv9_wgrad_bf16_splits). Negative CUDA error code on
// failure (-1 for a K the kernel does not take).
SSHSLIE_EXPORT int sshslie_conv9_wgrad_resident_bf16(int K) {
  switch (K) {
    case 3: return resident_bf16<3>();
    case 5: return resident_bf16<5>();
    case 7: return resident_bf16<7>();
    case 9: return resident_bf16<9>();
    case 11: return resident_bf16<11>();
    case 13: return resident_bf16<13>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, dy: (B, H, W, 64) float32; part: (splits, K, K, 64, 64) float32
// scratch; dw: (K, K, 64, 64) float32 HWIO. All contiguous and 16-byte
// aligned; K odd, 3..13; splits from sshslie_conv9_wgrad_splits, at most B*H.
SSHSLIE_EXPORT int sshslie_conv9_wgrad_f32(const void* x, const void* dy, void* part, void* dw,
                                           int B, int H, int W, int K, int splits,
                                           void* stream) {
  return wgrad_entry<float>(x, dy, part, dw, B, H, W, K, splits, stream);
}

// The same with x and dy in bfloat16; part and dw stay float32. splits at
// most B*H (ops/conv9.py::conv9_wgrad_bf16_splits).
SSHSLIE_EXPORT int sshslie_conv9_wgrad_bf16(const void* x, const void* dy, void* part, void* dw,
                                            int B, int H, int W, int K, int splits,
                                            void* stream) {
  return wgrad_entry<__nv_bfloat16>(x, dy, part, dw, B, H, W, K, splits, stream);
}

// How many pixel-row slices sshslie_conv9_wgrad_tf32 splits the reduction
// into, for this card (one wave of its resident blocks). Negative CUDA
// error code on failure (-1 for a K the kernel does not take).
SSHSLIE_EXPORT int sshslie_conv9_wgrad_splits_tf32(int B, int H, int K) {
  switch (K) {
    case 3: return splits_tf32<3>(B, H);
    case 5: return splits_tf32<5>(B, H);
    case 7: return splits_tf32<7>(B, H);
    case 9: return splits_tf32<9>(B, H);
    case 11: return splits_tf32<11>(B, H);
    case 13: return splits_tf32<13>(B, H);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same as sshslie_conv9_wgrad_f32 with x and dy rounded to TF32 and the
// products on the tensor cores (float32 sums, partials and dw). splits from
// sshslie_conv9_wgrad_splits_tf32, at most B*H.
SSHSLIE_EXPORT int sshslie_conv9_wgrad_tf32(const void* x, const void* dy, void* part, void* dw,
                                            int B, int H, int W, int K, int splits,
                                            void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dy);
  float* pf = static_cast<float*>(part);
  float* wf = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 3: return launch_tf32<3>(xf, df, pf, wf, B, H, W, splits, st);
    case 5: return launch_tf32<5>(xf, df, pf, wf, B, H, W, splits, st);
    case 7: return launch_tf32<7>(xf, df, pf, wf, B, H, W, splits, st);
    case 9: return launch_tf32<9>(xf, df, pf, wf, B, H, W, splits, st);
    case 11: return launch_tf32<11>(xf, df, pf, wf, B, H, W, splits, st);
    case 13: return launch_tf32<13>(xf, df, pf, wf, B, H, W, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many pixel-row slices sshslie_conv9_wgrad_wide_f32 splits the reduction
// into for Cin input channels on this card: the wrapper allocates
// splits*K*K*Cin*64 floats of scratch. Negative CUDA error code on failure
// (-1 for a K or Cin the kernel does not take).
SSHSLIE_EXPORT int sshslie_conv9_wgrad_wide_splits(int B, int H, int Cin, int K) {
  int splits = -static_cast<int>(cudaErrorInvalidValue);
  if (wide_channels(Cin))
    with_k(K, [&](auto k) {
      splits = splits_for<decltype(k)::value, 0>(B, H, Cin);
      return 0;
    });
  return splits;
}

// The float32 weight gradient at other input-channel counts: x (B, H, W, Cin)
// float32, Cin a multiple of 32 up to 256, dy (B, H, W, 64) float32; part
// (splits, K, K, Cin, 64) float32 scratch; dw (K, K, Cin, 64) float32 HWIO.
// The same blocks, sums and slice order as sshslie_conv9_wgrad_f32. splits
// from sshslie_conv9_wgrad_wide_splits, at most B*H.
SSHSLIE_EXPORT int sshslie_conv9_wgrad_wide_f32(const void* x, const void* dy, void* part,
                                                void* dw, int B, int H, int W, int Cin, int K,
                                                int splits, void* stream) {
  if (!wide_channels(Cin) || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_k(K, [&](auto k) {
    return launch_wide<decltype(k)::value>(
        static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(part),
        static_cast<float*>(dw), B, H, W, Cin, splits, static_cast<cudaStream_t>(stream));
  });
}
