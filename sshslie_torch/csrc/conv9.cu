// Stride-1 SAME k x k convolution, 64 -> 64 channels, float32 in and out,
// float32 accumulation: the DecompositionNet's 9x9 shallow conv.
//
// Replaces: sshslie_tpu/ops/conv_pallas.py::conv9_fwd (Pallas kernel
// _fwd_kernel). Same function: y[b,h,w,co] = sum_{kh,kw,ci}
// xpad[b,h+kh,w+kw,ci] * w[kh,kw,ci,co], NHWC x HWIO -> NHWC, no bias (the
// wrapper adds it outside, as the JAX package does). The TPU kernel's
// width-pairing to 128 lanes and its W % 128 gate are MXU tiling rules and
// are not carried over: any H, W works here, the ragged edge is masked.
//
// What bounds it on an H100: arithmetic. One 512x512x64 forward at k = 9 is
// 2*512^2*81*64*64 = 1.74e11 FLOP against ~135 MB in and out, so ~1300 FLOP a
// byte; float32 outside the tensor cores (TF32 is off for parity) peaks at
// 67 TFLOP/s, which makes 2.6 ms the floor, against 0.04 ms for the bytes.
//
// Design, an implicit GEMM on the CUDA cores:
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
// No tensor cores, TMA or pipelining yet: a right first kernel. Those are
// later work.
//
// bfloat16 entry (sshslie_conv_c64_bf16): the same kernel on bfloat16 x and
// w (conv_pallas.py::conv9_fwd on bfloat16 operands): the halo'd input and
// the weights are widened to float32 as they are staged in shared memory,
// products and sums are float32, and the output is rounded to bfloat16 once.
// It also serves the bfloat16 input gradient (ShallowConv.backward, as
// _psc_bwd). Its floor is the same 2.6 ms of float32 FMA at 512^2; the
// card's own floor for this work in bfloat16 is the tensor cores' 989
// TFLOP/s, 0.18 ms, which this form does not reach (a later kernel's work).
#include "common.cuh"

namespace {

constexpr int kC = 64;         // input and output channels
constexpr int kTH = 8;         // output tile rows per block
constexpr int kTW = 32;        // output tile columns per block
constexpr int kCC = 4;         // input channels staged per chunk
constexpr int kPix = 8;        // output pixels per thread (one row segment)
constexpr int kThreads = 256;  // 32 pixel groups x 8 channel groups

template <int K>
struct Tile {
  static constexpr int kInH = kTH + K - 1;
  static constexpr int kInW = kTW + K - 1;
  static constexpr int kInFloats = kCC * kInH * kInW;
  static constexpr int kWFloats = K * K * kCC * kC;
  static constexpr int kSmemBytes = 4 * (kWFloats + kInFloats);
};

template <int K, class E>
__global__ void __launch_bounds__(kThreads, 2)
conv_c64_kernel(const E* __restrict__ x, const E* __restrict__ w,
                E* __restrict__ y, int H, int W) {
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
  const E* xb = x + static_cast<size_t>(blockIdx.z) * H * W * kC;

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
      E* o = y + ((static_cast<size_t>(blockIdx.z) * H + oh) * W + ow) * kC;
      store4(o + cg * 4, make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
      store4(o + 32 + cg * 4, make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]));
    }
  }
}

template <int K, class T>
int launch(const T* x, const T* w, T* y, int B, int H, int W, cudaStream_t stream) {
  constexpr int kSmem = Tile<K>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv_c64_kernel<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  conv_c64_kernel<K, T><<<grid, kThreads, kSmem, stream>>>(x, w, y, H, W);
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
