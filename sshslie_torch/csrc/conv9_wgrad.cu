// Weight gradient of the stride-1 SAME k x k convolution, 64 -> 64 channels,
// float32 in and out, float32 accumulation: the backward pass of the
// DecompositionNet's 9x9 shallow conv for its weights.
//
// Replaces: sshslie_tpu/ops/conv_pallas.py::conv9_wgrad (Pallas kernel
// _wgrad_kernel). Same function:
//   dw[kh,kw,ci,co] = sum_{b,h,w} xpad[b,h+kh,w+kw,ci] * dy[b,h,w,co],
// NHWC x NHWC -> HWIO. The TPU kernel sums every grid step into one
// VMEM-resident output over a sequential grid; Hopper's blocks run in
// parallel and in no order, so that does not carry over. Nor do the width
// pairing to 128 lanes and the W % 128 gate: any B, H, W works here.
//
// What bounds it on an H100: arithmetic. At the training shape
// (2, 128, 128, 64), k = 9, it is 2*32768*81*64*64 = 2.17e10 FLOP against
// ~18 MB in and out, so ~1200 FLOP a byte; float32 outside the tensor cores
// (TF32 is off for parity) peaks at 67 TFLOP/s: 0.32 ms, against ~5 us for
// the bytes.
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
// No tensor cores, TMA or pipelining yet: a right first kernel.
//
// bfloat16 entry (sshslie_conv9_wgrad_bf16): the same kernel on bfloat16 x
// and dY (conv_pallas.py::conv9_wgrad on bfloat16 operands): both are widened
// to float32 as they are staged in shared memory, and the partials, their
// fixed-order sum and dW stay float32, so repeats are bit-identical. At the
// bf16 training shape (8, 128, 128, 64) it is 8.7e10 FLOP: 1.3 ms of float32
// FMA, against 0.088 ms on the tensor cores, which this form does not use.
#include "common.cuh"

namespace {

constexpr int kC = 64;         // input and output channels
constexpr int kCiB = 16;       // input channels a block owns
constexpr int kTP = 64;        // pixels of a row staged at a time
constexpr int kSeg = 8;        // pixels a thread walks with one register window
constexpr int kThreads = 256;  // 16 input channels x 16 groups of 4 outputs

template <int K>
struct WTile {
  static constexpr int kInW = kTP + K - 1;
  static constexpr int kInWPad = kInW | 1;  // odd row stride: fewer bank conflicts
};

template <int K, class E>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_c64_kernel(const E* __restrict__ x, const E* __restrict__ dy,
                 float* __restrict__ part, int B, int H, int W, int splits) {
  using T = WTile<K>;
  constexpr int P = (K - 1) / 2;
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
    const E* xrow = x + (static_cast<size_t>(b) * H + hx) * W * kC;
    const E* drow = dy + (static_cast<size_t>(b) * H + h) * W * kC;
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
          v = load4(xrow + static_cast<size_t>(gw) * kC + ci0 + q * 4);
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
  float* out = part + static_cast<size_t>(s) * K * K * kC * kC;
#pragma unroll
  for (int kw = 0; kw < K; ++kw) {
    float* o = out + ((static_cast<size_t>(kh) * K + kw) * kC + ci0 + cil) * kC + cog * 4;
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

template <int K, class E>
int splits_for(int B, int H) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgrad_c64_kernel<K, E>, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  // One wave of resident blocks: (kC / kCiB) * K blocks a slice.
  const long long capacity = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long splits = capacity / ((kC / kCiB) * K);
  const long long rows = static_cast<long long>(B) * H;
  if (splits > rows) splits = rows;
  return static_cast<int>(splits < 1 ? 1 : splits);
}

template <int K, class E>
int launch(const E* x, const E* dy, float* part, float* dw, int B, int H, int W,
           int splits, cudaStream_t stream) {
  const dim3 grid(splits, kC / kCiB, K);
  wgrad_c64_kernel<K, E><<<grid, kThreads, 0, stream>>>(x, dy, part, B, H, W, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n4 = K * K * kC * kC / 4;
  const int blocks = (n4 + 255) / 256;
  wgrad_reduce_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                                  reinterpret_cast<float4*>(dw), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int splits_entry(int B, int H, int K) {
  switch (K) {
    case 3: return splits_for<3, E>(B, H);
    case 5: return splits_for<5, E>(B, H);
    case 7: return splits_for<7, E>(B, H);
    case 9: return splits_for<9, E>(B, H);
    case 11: return splits_for<11, E>(B, H);
    case 13: return splits_for<13, E>(B, H);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
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

}  // namespace

// How many pixel-row slices sshslie_conv9_wgrad_f32 splits the reduction
// into, for this card: the wrapper allocates splits*K*K*64*64 floats of
// scratch. Returns a negative CUDA error code on failure (-1 for a K the
// kernel does not take).
SSHSLIE_EXPORT int sshslie_conv9_wgrad_splits(int B, int H, int K) {
  return splits_entry<float>(B, H, K);
}

// The same for sshslie_conv9_wgrad_bf16.
SSHSLIE_EXPORT int sshslie_conv9_wgrad_splits_bf16(int B, int H, int K) {
  return splits_entry<__nv_bfloat16>(B, H, K);
}

// x, dy: (B, H, W, 64) float32; part: (splits, K, K, 64, 64) float32
// scratch; dw: (K, K, 64, 64) float32 HWIO. All contiguous and 16-byte
// aligned; K odd, 3..13; splits from sshslie_conv9_wgrad_splits, at most B*H.
SSHSLIE_EXPORT int sshslie_conv9_wgrad_f32(const void* x, const void* dy, void* part, void* dw,
                                           int B, int H, int W, int K, int splits,
                                           void* stream) {
  return wgrad_entry<float>(x, dy, part, dw, B, H, W, K, splits, stream);
}

// The same with x and dy in bfloat16; part and dw stay float32. splits from
// sshslie_conv9_wgrad_splits_bf16.
SSHSLIE_EXPORT int sshslie_conv9_wgrad_bf16(const void* x, const void* dy, void* part, void* dw,
                                            int B, int H, int W, int K, int splits,
                                            void* stream) {
  return wgrad_entry<__nv_bfloat16>(x, dy, part, dw, B, H, W, K, splits, stream);
}
