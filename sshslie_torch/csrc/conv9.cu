// Stride-1 SAME k x k convolution, 64 -> 64 channels, float32 accumulation:
// the DecompositionNet's 9x9 shallow conv, with a float32, a bfloat16 and a
// TF32 entry, and a float32 entry from other input-channel counts (the wide
// entry).
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
// float32 entry (sshslie_conv_c64_f32): exact float32 products on the CUDA
// cores (FFMA), each output's sum in one fixed order, ci, then kh, then kw:
// the order of the entry's first kernel (one 256-thread block an 8 x 32
// tile, all 64 channels), whose outputs this one equals bit for bit.
// What bounds it on an H100: arithmetic. One 512x512x64 forward at k = 9 is
// 2*512^2*81*64*64 = 1.74e11 FLOP against ~135 MB in and out, ~1300 FLOP a
// byte; float32 outside the tensor cores peaks at 67 TFLOP/s (an FFMA loop
// alone runs at 65.5 on the card at 1980 MHz, tools/tc_probe.py --ffma),
// which makes 2.6 ms the floor, against 0.04 ms for the bytes. Design, an
// implicit GEMM on the CUDA cores:
//   * A block of 128 threads (4 warps, one on each scheduler of its SM) owns
//     a unit: a 4 x 32 pixel output tile and 64 / parts of its output
//     channels, parts = 1, 2 or 4 chosen at launch from the shape and the
//     card's SMs (ops/conv9.py::conv9_f32_parts): the busiest SM's share of
//     the work sets the time, so a small grid splits its tiles' channels
//     until every SM has work. A thread keeps P pixels of one row times CT
//     channels in registers: 16 x 4 (parts 1), 16 x 2 (parts 2), 8 x 2
//     (parts 4).
//   * A prep kernel writes the input planar and zero-padded (a channel's
//     image row is contiguous, the padding real zeros) and the weights as
//     [part][ci][tap][channel]. The conv kernel then walks the input
//     channels one at a time through a ring of two stages; warp 0 fills a
//     stage with bulk copies (cp.async.bulk: one for the channel's taps, one
//     a window row) that complete on the stage's mbarrier. One __syncthreads
//     a channel; channel ci + 1 lands while channel ci is computed.
//   * Per kernel row a thread asks for the row's K taps of its weights
//     before its first product, and slides along its row's input values as
//     float4 chunks, each loaded a tap before its first use (a row's first
//     chunks in the row before). A window row is 4 mod 8 floats long, so a
//     warp's input loads take few wavefronts.
//   * Measured on an H100 (PERF.md; tools/conv_bench.py): 3.47 ms at 512^2
//     (75% of the bound; the first kernel 3.91), 0.466 ms at b2 x 128^2,
//     0.273 at b1 x 128^2 (the first kernel: 0.52 for both, one wave of 64
//     or 128 blocks). What holds the loop: the weights' shared-memory
//     loads. It is 94-96% FFMA (tools/sass_stats.py) but runs at ~75%: with
//     the weights loaded once a channel (wrong sums) it ran at 81%, with
//     the input loads gone too no faster. 16 pixels a thread halve the
//     weight loads a product (8 x 8 channels: 3.64 ms). Tried and dropped:
//     per-thread cp.async staging of 4-byte input gathers (3.86 ms with 8 x
//     8), the next tap's weights a tap ahead (ptxas issues each load ~30
//     FFMAs before its use: 5% slower than a row's weights at once), a warp
//     of 2 channel groups x 16 pixel groups (broadcast weight loads: the
//     same time), two rows of 8 pixels a thread in an 8-row tile, the
//     FFMAs in inline asm groups, ptxas -O2, single-buffered weights, the
//     whole row's input at its start.
//   * The wide entry (sshslie_conv_wide_f32): the same units, splits and
//     summation order over Cin input channels, a multiple of 32 up to 256,
//     to 64 output channels: 224 -> 64 for 224-band cubes. A unit walks Cin
//     input channels; its prep kernel transposes 32 channels a block. Same
//     code as the 64-channel kernels (conv_f32_unit, prep_f32), which keep
//     their own instantiations.
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
constexpr int kThreads = 256;  // the bfloat16 and TF32 entries: 2 warpgroups

// ---- float32 entry: FFMA on the CUDA cores ----

constexpr int kThreadsF = 128;  // 4 warps, one a scheduler
constexpr int kTHf = 4;         // output tile rows per block
constexpr int kTWf = 32;        // output tile columns per block

// K: kernel size; P: output pixels a thread (one row); CT: output channels a
// thread, 4 or 2. A block has P channel groups of CT channels and 128 / P
// pixel groups: parts 1 is P = 16, CT = 4; parts 2 is 16, 2; parts 4 is 8, 2.
template <int K, int P, int CT>
struct F32Tile {
  static constexpr int kK = K;
  static constexpr int kP = P;
  static constexpr int kCT = CT;
  static constexpr int kCoB = P * CT;                  // output channels of a unit
  static constexpr int kNX4 = (P + K - 1 + 3) / 4;     // float4 of input a thread's row
  static constexpr int kInH = kTHf + K - 1;
  // The window's row: >= kTWf + K - 1 and the last chunk a thread reads, and
  // = 4 mod 8 floats, so that a warp's input loads take few wavefronts.
  static constexpr int kInW0 = kTWf - P + 4 * kNX4 > kTWf + K - 1 ? kTWf - P + 4 * kNX4
                                                                  : kTWf + K - 1;
  static constexpr int kInW = kInW0 + (12 - kInW0 % 8) % 8;
  static constexpr int kWFloats = K * K * kCoB;        // one input channel's taps
  static constexpr int kStageFloats = kWFloats + kInH * kInW;
  static constexpr int kStageBytes = 4 * kStageFloats;
  static constexpr int kSmemBytes = 2 * kStageBytes + 16;  // two stages, two mbarriers
  // Registers: P CT accumulators, a kernel row's K CT weights, a row of input.
  static constexpr int kMinBlocks = P * CT == 64 ? (K <= 11 ? 3 : 2) : (K <= 9 ? 5 : 4);
  static_assert(CT == 4 || CT == 2, "4 or 2 output channels a thread");
};

// One-thread bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of mbarrier `bar` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// A thread's CT consecutive output channels of one tap, from p.
template <int CT>
__device__ __forceinline__ void load_tap(float (&v)[CT], const float* p) {
  if constexpr (CT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const float4 a = lds4(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
}

// Taps at which chunk c (input values 4c .. 4c+3) of a thread's row is first
// and last used: value v serves pixels v - kw, 0 <= v - kw < P.
template <class T>
__device__ constexpr int first_tap(int c) {
  return 4 * c - (T::kP - 1) > 0 ? 4 * c - (T::kP - 1) : 0;
}
template <class T>
__device__ constexpr int last_tap(int c) {
  return 4 * c + 3 < T::kK - 1 ? 4 * c + 3 : T::kK - 1;
}

// One input channel: all K x K taps into the accumulators, kh then kw.
// xrow: the thread's first input value in the stage's window; wt: its
// channels in the stage's tap 0 row.
template <class T>
__device__ __forceinline__ void conv_channel(float (&acc)[T::kP][T::kCT], const float* xrow,
                                             const float* wt) {
  constexpr int K = T::kK;
  constexpr int P = T::kP;
  constexpr int CT = T::kCT;
  constexpr int kNX4 = T::kNX4;
  constexpr int kEarly = P / 4;  // chunks first used at tap 0
  float4 xc[kNX4];
#pragma unroll
  for (int c = 0; c < kEarly; ++c) xc[c] = lds4(xrow + 4 * c);
#pragma unroll 1
  for (int kh = 0; kh < K; ++kh) {
    const float* xr = xrow + kh * T::kInW;
    const float* xn = xr + (kh + 1 < K ? T::kInW : 0);
    // The row's K taps of weights, all asked for before its first product:
    // ptxas then places each load well ahead of its use (a load a tap ahead
    // ran 5% slower).
    float wrow[K][CT];
#pragma unroll
    for (int t = 0; t < K; ++t) load_tap<CT>(wrow[t], wt + (kh * K + t) * T::kCoB);
    float4 xnext[kEarly];
#pragma unroll
    for (int kw = 0; kw < K; ++kw) {
      // A chunk first used at tap f >= 1 is loaded at tap f - 1; one first
      // used at tap 0 is loaded for the next row at the tap after its last
      // use in this one (or at the last tap).
#pragma unroll
      for (int c = kEarly; c < kNX4; ++c)
        if (kw == first_tap<T>(c) - 1) xc[c] = lds4(xr + 4 * c);
#pragma unroll
      for (int c = 0; c < kEarly; ++c)
        if (kw == (last_tap<T>(c) + 1 < K ? last_tap<T>(c) + 1 : K - 1)) xnext[c] = lds4(xn + 4 * c);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float xv = lane4(xc[(j + kw) >> 2], (j + kw) & 3);
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[j][c] = fmaf(xv, wrow[kw][c], acc[j][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kEarly; ++c) xc[c] = xnext[c];
  }
}

// The input as the kernel reads it, planar and zero-padded: xp[b][c][hp][wp],
// image pixel (h, w) at (h + P, w + P), Hp = 4 tiles_h + K - 1 rows and
// Wp = (tiles_w - 1) * 32 + kInW columns, so that a unit's window for one
// channel is kInH whole rows of kInW values; and the weights as
// wp[part][ci][tap][kCoB], a channel's taps of a part in one piece. cin: the
// input channels; a block of the input transposes CH of them (all 64 in the
// 64-channel entry, 32 in the wide one).
template <class T, int CH>
__device__ __forceinline__ void prep_f32(const float* __restrict__ x, const float* __restrict__ w,
                                         float* __restrict__ xp, float* __restrict__ wp, int H,
                                         int W, int Hp, int Wp, int x_blocks, int cin) {
  constexpr int K = T::kK;
  constexpr int P = (K - 1) / 2;
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= x_blocks) {  // the weights, 1024 floats a block
    const int i = (blockIdx.x - x_blocks) * 256 + tid;  // float4 of wp
    if (i >= K * K * cin * kC / 4) return;
    const int q = i % (T::kCoB / 4);
    const int tap = (i / (T::kCoB / 4)) % (K * K);
    const int ci = (i / (T::kCoB / 4 * K * K)) % cin;
    const int part = i / (T::kCoB / 4 * K * K * cin);
    store4(wp + 4 * static_cast<size_t>(i),
           load4(w + (static_cast<size_t>(tap) * cin + ci) * kC + part * T::kCoB + 4 * q));
    return;
  }
  // The input: 32 padded columns of one padded row, CH channels, through a
  // [column][channel] tile (CH + 1 floats a column: conflict-free both ways).
  __shared__ float tile[32][CH + 1];
  const int col_tiles = (Wp + 31) / 32;
  const int c0 = (blockIdx.x % col_tiles) * 32;
  const int hp = (blockIdx.x / col_tiles) % Hp;
  const int bc = blockIdx.x / (col_tiles * Hp);  // (image, channel chunk), the chunk fastest
  const int b = bc / (cin / CH);
  const int ch0 = bc % (cin / CH) * CH;
  const int h = hp - P;
#pragma unroll
  for (int i = tid; i < 32 * CH / 4; i += 256) {
    const int col = i / (CH / 4);
    const int q = i % (CH / 4);
    const int wc = c0 + col - P;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h >= 0 && h < H && wc >= 0 && wc < W)
      v = load4(x + ((static_cast<size_t>(b) * H + h) * W + wc) * cin + ch0 + 4 * q);
    tile[col][4 * q] = v.x;
    tile[col][4 * q + 1] = v.y;
    tile[col][4 * q + 2] = v.z;
    tile[col][4 * q + 3] = v.w;
  }
  __syncthreads();
#pragma unroll
  for (int i = tid; i < 32 * CH; i += 256) {
    const int c = i / 32;
    const int col = i % 32;
    if (c0 + col < Wp)
      xp[((static_cast<size_t>(b) * cin + ch0 + c) * Hp + hp) * Wp + c0 + col] = tile[col][c];
  }
}

template <class T>
__global__ void __launch_bounds__(256)
conv_c64_f32_prep_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ xp, float* __restrict__ wp, int H, int W, int Hp,
                         int Wp, int x_blocks) {
  prep_f32<T, kC>(x, w, xp, wp, H, W, Hp, Wp, x_blocks, kC);
}

// One unit of the float32 conv, cin channels in and the unit's kCoB of the 64
// out: the body of both float32 kernels.
template <class T>
__device__ __forceinline__ void conv_f32_unit(const float* __restrict__ xp,
                                              const float* __restrict__ wp, float* __restrict__ y,
                                              int H, int W, int Hp, int Wp, int tiles_h,
                                              int tiles_w, int cin) {
  constexpr int P = T::kP;
  constexpr int CT = T::kCT;
  constexpr int kParts = kC / T::kCoB;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);  // 2 x ([K*K][kCoB] taps, window)
  const unsigned bars = smem_u32(smem) + 2 * T::kStageBytes;  // two mbarriers: stage full

  // The unit: (batch, tile row, tile column, channel part), the part fastest.
  int u = blockIdx.x;
  const int part = u % kParts;
  u /= kParts;
  const int w0 = (u % tiles_w) * kTWf;
  u /= tiles_w;
  const int h0 = (u % tiles_h) * kTHf;
  const int b = u / tiles_h;
  const int co0 = part * T::kCoB;

  // Warp w: channel groups P/4 w .. P/4 (w + 1) - 1 times all 128 / P pixel
  // groups.
  const int tid = threadIdx.x;
  const int cg = P / 4 * (tid >> 5) + (tid & 31) % (P / 4);  // channel group
  const int pg = (tid & 31) / (P / 4);                       // pixel group
  const int prow = pg / (kTWf / P);           // tile row
  const int pcol = pg % (kTWf / P) * P;       // tile column of the first pixel
  const int wo = CT * cg;                     // the thread's channels in a tap row

  // Channel ci's stage into buffer ci & 1, by warp 0: the part's taps in one
  // copy, the window's kInH rows one a lane, all completing on the buffer's
  // mbarrier.
  auto issue = [&](int ci) {
    const unsigned ws = smem_u32(smem) + (ci & 1) * T::kStageBytes;
    const unsigned bar = bars + 8 * (ci & 1);
    if (tid == 0) {
      mbar_expect_tx(bar, T::kStageBytes);
      bulk_copy(ws, wp + (static_cast<size_t>(part) * cin + ci) * T::kWFloats, 4 * T::kWFloats,
                bar);
    }
    __syncwarp();
    const float* src = xp + ((static_cast<size_t>(b) * cin + ci) * Hp + h0) * Wp + w0;
    for (int r = tid; r < T::kInH; r += 32)
      bulk_copy(ws + 4 * (T::kWFloats + r * T::kInW), src + static_cast<size_t>(r) * Wp,
                4 * T::kInW, bar);
  };
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[P][CT];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[j][c] = 0.f;

  if (tid < 32) issue(0);
#pragma unroll 1
  for (int ci = 0; ci < cin; ++ci) {
    if (ci > 0) __syncthreads();  // every thread is done with channel ci - 1: its buffer is free
    if (tid < 32 && ci + 1 < cin) issue(ci + 1);
    mbar_wait(bars + 8 * (ci & 1), (ci >> 1) & 1);  // channel ci landed
    const float* ws = smem + (ci & 1) * T::kStageFloats;
    conv_channel<T>(acc, ws + T::kWFloats + prow * T::kInW + pcol, ws + wo);
  }

  const int oh = h0 + prow;
  if (oh >= H) return;
  float* yrow = y + (static_cast<size_t>(b) * H + oh) * W * kC + co0 + wo;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int ow = w0 + pcol + j;
    if (ow < W) {
      float* o = yrow + static_cast<size_t>(ow) * kC;
      if constexpr (CT == 2)
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
      else
        store4(o, make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kThreadsF, T::kMinBlocks)
conv_c64_f32_kernel(const float* __restrict__ xp, const float* __restrict__ wp,
                    float* __restrict__ y, int H, int W, int Hp, int Wp, int tiles_h,
                    int tiles_w) {
  conv_f32_unit<T>(xp, wp, y, H, W, Hp, Wp, tiles_h, tiles_w, kC);
}

// The wide entry's kernels: the same units over cin input channels, a
// multiple of 32 up to 256 (224 for 224-band cubes), to 64 output channels.
// Their names hold "wide_f32" and none of the 64-channel kernels' or cuDNN's
// name patterns.
constexpr int kWideChunk = 32;  // input channels a block of the wide prep transposes

template <class T>
__global__ void __launch_bounds__(256)
wide_f32_prep_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ xp, float* __restrict__ wp, int H, int W, int Hp, int Wp,
                     int x_blocks, int cin) {
  prep_f32<T, kWideChunk>(x, w, xp, wp, H, W, Hp, Wp, x_blocks, cin);
}

template <class T>
__global__ void __launch_bounds__(kThreadsF, T::kMinBlocks)
wide_f32_kernel(const float* __restrict__ xp, const float* __restrict__ wp, float* __restrict__ y,
                int H, int W, int Hp, int Wp, int tiles_h, int tiles_w, int cin) {
  conv_f32_unit<T>(xp, wp, y, H, W, Hp, Wp, tiles_h, tiles_w, cin);
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

// f(F32Tile<K, P, CT>()) of the split `parts` for a runtime (K, parts).
template <int K, class F>
int with_parts(int parts, F&& f) {
  switch (parts) {
    case 1: return f(F32Tile<K, 16, 4>());
    case 2: return f(F32Tile<K, 16, 2>());
    case 4: return f(F32Tile<K, 8, 2>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class F>
int with_form(int K, int parts, F&& f) {
  switch (K) {
    case 3: return with_parts<3>(parts, f);
    case 5: return with_parts<5>(parts, f);
    case 7: return with_parts<7>(parts, f);
    case 9: return with_parts<9>(parts, f);
    case 11: return with_parts<11>(parts, f);
    case 13: return with_parts<13>(parts, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The float32 entry's padded input rows and columns (see the prep kernel).
template <class T>
void f32_padded(int H, int W, int* Hp, int* Wp, int* tiles_h, int* tiles_w) {
  *tiles_h = (H + kTHf - 1) / kTHf;
  *tiles_w = (W + kTWf - 1) / kTWf;
  *Hp = *tiles_h * kTHf + T::kK - 1;
  *Wp = (*tiles_w - 1) * kTWf + T::kInW;
}

// with_form for the wide entry's cin input channels, or cudaErrorInvalidValue
// for a count it does not take.
template <class F>
int with_wide_form(int K, int cin, int parts, F&& f) {
  if (cin < 32 || cin > 256 || cin % 32) return static_cast<int>(cudaErrorInvalidValue);
  return with_form(K, parts, f);
}

}  // namespace

// Floats of scratch the float32 entry needs for (B, H, W, K) split `parts`
// ways: the planar padded input and the repacked weights; -1 for a K or
// parts it does not take.
SSHSLIE_EXPORT long long sshslie_conv_c64_f32_scratch(int B, int H, int W, int K, int parts) {
  long long floats = -1;
  with_form(K, parts, [&](auto tile) {
    using T = decltype(tile);
    int Hp, Wp, th, tw;
    f32_padded<T>(H, W, &Hp, &Wp, &th, &tw);
    floats = static_cast<long long>(B) * kC * Hp * Wp + static_cast<long long>(K) * K * kC * kC;
    return 0;
  });
  return floats;
}

// x: (B, H, W, 64) float32, w: (K, K, 64, 64) float32 HWIO, y: (B, H, W, 64)
// float32; all contiguous and 16-byte aligned. K odd, 3..13. parts 1, 2 or
// 4: the output channels of a 4 x 32 tile split over that many blocks
// (every choice gives the same bits). scratch:
// sshslie_conv_c64_f32_scratch(...) floats, 16-byte aligned. Two launches:
// the prep kernel, then the conv.
SSHSLIE_EXPORT int sshslie_conv_c64_f32(const void* x, const void* w, void* y, void* scratch,
                                        int B, int H, int W, int K, int parts, void* stream) {
  return with_form(K, parts, [&](auto tile) {
    using T = decltype(tile);
    const auto kernel = conv_c64_f32_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int Hp, Wp, tiles_h, tiles_w;
    f32_padded<T>(H, W, &Hp, &Wp, &tiles_h, &tiles_w);
    const long long blocks = static_cast<long long>(B) * tiles_h * tiles_w * parts;
    const long long x_blocks = static_cast<long long>(B) * Hp * ((Wp + 31) / 32);
    const int w_blocks = (K * K * kC * kC / 4 + 255) / 256;
    if (blocks > 0x7fffffffLL || x_blocks + w_blocks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    float* xp = static_cast<float*>(scratch);
    float* wp = xp + static_cast<size_t>(B) * kC * Hp * Wp;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    conv_c64_f32_prep_kernel<T><<<static_cast<unsigned>(x_blocks + w_blocks), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), xp, wp, H, W, Hp, Wp,
        static_cast<int>(x_blocks));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(blocks), kThreadsF, T::kSmemBytes, s>>>(
        xp, wp, static_cast<float*>(y), H, W, Hp, Wp, tiles_h, tiles_w);
    return static_cast<int>(cudaGetLastError());
  });
}

// The current device's SM count and the blocks of the float32 kernel for
// (K, parts) that one SM holds at once; returns a CUDA error code.
SSHSLIE_EXPORT int sshslie_conv_c64_f32_resident(int K, int parts, int* sms, int* per_sm) {
  return with_form(K, parts, [&](auto tile) {
    using T = decltype(tile);
    const auto kernel = conv_c64_f32_kernel<T>;
    int dev = 0;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreadsF,
                                                          T::kSmemBytes);
    return static_cast<int>(err);
  });
}

// Floats of scratch the wide float32 entry needs for (B, H, W, Cin, K) split
// `parts` ways; -1 for what it does not take.
SSHSLIE_EXPORT long long sshslie_conv_wide_f32_scratch(int B, int H, int W, int Cin, int K,
                                                       int parts) {
  long long floats = -1;
  with_wide_form(K, Cin, parts, [&](auto tile) {
    using T = decltype(tile);
    int Hp, Wp, th, tw;
    f32_padded<T>(H, W, &Hp, &Wp, &th, &tw);
    floats = static_cast<long long>(B) * Cin * Hp * Wp + static_cast<long long>(K) * K * Cin * kC;
    return 0;
  });
  return floats;
}

// The float32 entry at other input-channel counts: x (B, H, W, Cin), w (K, K,
// Cin, 64) HWIO, y (B, H, W, 64), Cin a multiple of 32 up to 256. The same
// units, splits (parts 1, 2 or 4), sums and summation order as
// sshslie_conv_c64_f32 over Cin input channels (every split gives the same
// bits). scratch: sshslie_conv_wide_f32_scratch(...) floats.
SSHSLIE_EXPORT int sshslie_conv_wide_f32(const void* x, const void* w, void* y, void* scratch,
                                         int B, int H, int W, int Cin, int K, int parts,
                                         void* stream) {
  return with_wide_form(K, Cin, parts, [&](auto tile) {
    using T = decltype(tile);
    const auto kernel = wide_f32_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int Hp, Wp, tiles_h, tiles_w;
    f32_padded<T>(H, W, &Hp, &Wp, &tiles_h, &tiles_w);
    const long long blocks = static_cast<long long>(B) * tiles_h * tiles_w * parts;
    const long long x_blocks =
        static_cast<long long>(B) * (Cin / kWideChunk) * Hp * ((Wp + 31) / 32);
    const long long w_blocks = (static_cast<long long>(K) * K * Cin * kC / 4 + 255) / 256;
    if (blocks > 0x7fffffffLL || x_blocks + w_blocks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    float* xp = static_cast<float*>(scratch);
    float* wp = xp + static_cast<size_t>(B) * Cin * Hp * Wp;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    wide_f32_prep_kernel<T><<<static_cast<unsigned>(x_blocks + w_blocks), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), xp, wp, H, W, Hp, Wp,
        static_cast<int>(x_blocks), Cin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(blocks), kThreadsF, T::kSmemBytes, s>>>(
        xp, wp, static_cast<float*>(y), H, W, Hp, Wp, tiles_h, tiles_w, Cin);
    return static_cast<int>(cudaGetLastError());
  });
}

// The current device's SM count and the blocks of the wide float32 kernel,
// unsplit, that one SM holds at once; returns a CUDA error code.
SSHSLIE_EXPORT int sshslie_conv_wide_f32_resident(int K, int* sms, int* per_sm) {
  return with_form(K, 1, [&](auto tile) {
    using T = decltype(tile);
    const auto kernel = wide_f32_kernel<T>;
    int dev = 0;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreadsF,
                                                          T::kSmemBytes);
    return static_cast<int>(err);
  });
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
