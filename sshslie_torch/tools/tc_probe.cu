// Probe of the H100's tensor-core forms for the bfloat16 and TF32 conv
// kernels (run by tc_probe.py):
//   * layout checks of the wgmma helpers in ../csrc/mma.cuh: m64n64k16
//     with a K-major B (conv9.cu) and an MN-major B (conv9_wgrad.cu), and
//     m64n64k8 .tf32 with a K-major B (conv9.cu's TF32 entry), each read
//     through a descriptor that starts at an arbitrary row of a
//     128-byte-swizzled tile, as the conv kernels address a tap's shifted
//     pixel window, with A from registers; and the TF32 weight gradient's
//     form (conv9_wgrad.cu): A dY^T from [px][co] rows, rounded as loaded;
//     B X^T K-major without swizzle, one of four phase copies from a start
//     that moves 128 bytes (4 pixels) a step; the first wgmma with scale-d
//     false;
//   * throughput of mma.sync m16n8k16 (with and without the ldmatrix loads
//     of a 64 x 64 warp tile; both helpers from mma.cuh, as flash_attn.cu
//     uses them) and of wgmma with A from registers (bfloat16 k16 and
//     TF32 k8), in loops on data already in shared memory and registers.
#include "common.cuh"
#include "mma.cuh"

namespace {

// d (64 x 32, float32) += a (64 x 16 bfloat16, registers) * B (16 x 32,
// K-major in shared memory at desc).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const unsigned (&a)[4],
                                                unsigned long long desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 0;\n"
      : SSHSLIE_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

__device__ __forceinline__ unsigned pair(const __nv_bfloat16* p) {
  return static_cast<unsigned>(__bfloat16_as_ushort(p[0])) |
         (static_cast<unsigned>(__bfloat16_as_ushort(p[1])) << 16);
}

// The A fragment of rows 16w .. 16w+15, k 16ks .. 16ks+15 of a row-major 64 x 64.
__device__ __forceinline__ void a_fragment(unsigned (&a)[4], const __nv_bfloat16* A, int w, int ks,
                                           int lane) {
  const __nv_bfloat16* r = A + (16 * w + (lane >> 2)) * 64 + ks * 16 + 2 * (lane & 3);
  a[0] = pair(r);
  a[1] = pair(r + 8 * 64);
  a[2] = pair(r + 8);
  a[3] = pair(r + 8 * 64 + 8);
}

// d (64 x 32, float32) += a (64 x 8 tf32, registers) * B (8 x 32, K-major
// in shared memory at desc).
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16], const unsigned (&a)[4],
                                                    unsigned long long desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1;\n"
      : SSHSLIE_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// X (R rows of 128 bytes: 64 bfloat16 or 32 float32) into a swizzled tile at
// a 1024-byte boundary.
__device__ unsigned stage_rows(unsigned char* smem, const void* X, int R) {
  const unsigned xs = (smem_u32(smem) + 1023) & ~1023u;
  const char* xb = static_cast<const char*>(X);
  for (int i = threadIdx.x; i < R * 8; i += blockDim.x)
    cp_async16(xs + swz128(i >> 3, i & 7), xb + (i >> 3) * 128 + (i & 7) * 16, 16);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  return xs;
}

// D (64 x 64) = A (64 x 64) X[s .. s+63]^T: K-major B from row s.
__global__ void kmajor_kernel(const __nv_bfloat16* A, const __nv_bfloat16* X, float* D, int R,
                              int s) {
  extern __shared__ unsigned char smem[];
  const unsigned xs = stage_rows(smem, X, R);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float d[32] = {};
  wgmma_fence();
  for (int ks = 0; ks < 4; ++ks) {
    unsigned a[4];
    a_fragment(a, A, w, ks, lane);
    wgmma_m64n64k16<0>(d, a, wgmma_desc(xs + s * 128 + ks * 32));
  }
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < 32; ++i)
    D[(16 * w + (lane >> 2) + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)] = d[i];
}

// D (64 x 64) = A (64 x 64) X[s .. s+63]: MN-major B from row s.
__global__ void mnmajor_kernel(const __nv_bfloat16* A, const __nv_bfloat16* X, float* D, int R,
                               int s) {
  extern __shared__ unsigned char smem[];
  const unsigned xs = stage_rows(smem, X, R);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float d[32] = {};
  wgmma_fence();
  for (int ks = 0; ks < 4; ++ks) {
    unsigned a[4];
    a_fragment(a, A, w, ks, lane);
    wgmma_m64n64k16<1>(d, a, wgmma_desc(xs + (s + 16 * ks) * 128));
  }
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < 32; ++i)
    D[(16 * w + (lane >> 2) + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)] = d[i];
}

// D (64 x 64) = A (64 x 32 tf32, row-major) X[s .. s+63]^T, X rows of 32
// float32: K-major B from row s, 4 k8 steps of 32 bytes. A's fragment of
// warp w, k step ks: rows 16w + g (+8), columns 8ks + t (+4).
__global__ void tf32_kmajor_kernel(const float* A, const float* X, float* D, int R, int s) {
  extern __shared__ unsigned char smem[];
  const unsigned xs = stage_rows(smem, X, R);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float d[32] = {};
  wgmma_fence();
  for (int ks = 0; ks < 4; ++ks) {
    const float* r = A + (16 * w + g) * 32 + 8 * ks + t;
    const unsigned a[4] = {__float_as_uint(r[0]), __float_as_uint(r[8 * 32]),
                           __float_as_uint(r[4]), __float_as_uint(r[8 * 32 + 4])};
    wgmma_m64n64k8_tf32(d, a, wgmma_desc(xs + s * 128 + ks * 32));
  }
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < 32; ++i)
    D[(16 * w + g + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * t + (i & 1)] = d[i];
}

// D (64 co x 64 ci) = DY^T (64 co x 64 px) X[s .. s+63] (64 px x 64 ci),
// both rounded to TF32 in the kernel: the TF32 wgrad form of one tap and
// segment, with X rows and DY as they lie in memory (64 floats a pixel),
// staged as conv9_wgrad.cu stages them (72-float rows; X then rounded into
// the four phase copies of X^T), B read from copy s % 4 at pixel 4 (s / 4).
__global__ void tf32_wgrad_kernel(const float* X, const float* DY, float* D, int R, int s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int pix = R - 3;                 // pixels of a copy (a multiple of 4)
  const int sbo = pix * 32;
  float* const xr = reinterpret_cast<float*>(smem + 4 * 8 * sbo);
  float* const dr = xr + R * 72;
  for (int i = threadIdx.x; i < R * 16; i += 128)
    cp_async16(smem_u32(xr + (i >> 4) * 72 + (i & 15) * 4), X + i * 4, 16);
  for (int i = threadIdx.x; i < 64 * 16; i += 128)
    cp_async16(smem_u32(dr + (i >> 4) * 72 + (i & 15) * 4), DY + i * 4, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < R * 64; i += 128) {
    const int p = i >> 6, ci = i & 63;
    const float v = tf32_rna(xr[p * 72 + ci]);
    for (int c = 0; c < 4; ++c)
      if (p - c >= 0 && p - c < pix)
        *reinterpret_cast<float*>(smem + c * 8 * sbo + xt_offset(ci, p - c, sbo)) = v;
  }
  fence_proxy_async();
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned a[8][4];
  for (int ks = 0; ks < 8; ++ks) rows_fragment_tf32<72>(a[ks], dr + 16 * w + g, 8 * ks + t);
  const unsigned long long desc = xt_desc(smem_u32(smem) + (s & 3) * 8 * sbo + (s >> 2) * 128, sbo);
  float d[32];
  wgmma_fence();
  wgmma_m64n64k8_tf32_first(d, a[0], desc);
  for (int ks = 1; ks < 8; ++ks) wgmma_m64n64k8_tf32(d, a[ks], desc + ((ks * 256) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < 32; ++i)
    D[(16 * w + g + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * t + (i & 1)] = d[i];
}

// TF32: 2 warpgroups, each NACC accumulator tiles of 64 x N, 4 k8 steps an
// iteration, B read from start row ROW of a 128-byte-swizzled tile.
template <int N, int NACC, int ROW>
__global__ void __launch_bounds__(256, 1) wgmma_tf32_loop(float* out, int iters) {
  __shared__ __align__(1024) unsigned char smem[16384];
  for (int i = threadIdx.x; i < 4096; i += 256)
    reinterpret_cast<float*>(smem)[i] = (i & 1) ? 1.f : 0.f;
  fence_proxy_async();
  __syncthreads();
  const unsigned base = smem_u32(smem) + ROW * 128;
  const unsigned a[4] = {0x3f800000u, 0x3f800000u, 0u, 0u};
  float d[NACC][N / 2];
  for (int m = 0; m < NACC; ++m)
    for (int i = 0; i < N / 2; ++i) d[m][i] = 0.f;
  wgmma_fence();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int m = 0; m < NACC; ++m) {
        if constexpr (N == 32) wgmma_m64n32k8_tf32(d[m], a, wgmma_desc(base + ks * 32));
        else wgmma_m64n64k8_tf32(d[m], a, wgmma_desc(base + ks * 32));
      }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float sum = 0.f;
  for (int m = 0; m < NACC; ++m)
    for (int i = 0; i < N / 2; ++i) sum += d[m][i];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}

// A TF32 chain: 2 warpgroups, each one accumulator tile of 64 x 64; an
// iteration is 8 k steps into it (8 dependent wgmma), committed, then waited
// for, as the TF32 wgrad kernel runs a tap's segment. B K-major with the
// 128-byte swizzle or (kInterleave) without swizzle, as the wgrad kernel's.
template <int kInterleave>
__global__ void __launch_bounds__(256, 1) wgmma_tf32_chains(float* out, int iters) {
  __shared__ __align__(1024) unsigned char smem[16384];
  for (int i = threadIdx.x; i < 4096; i += 256)
    reinterpret_cast<float*>(smem)[i] = (i & 1) ? 1.f : 0.f;
  fence_proxy_async();
  __syncthreads();
  const unsigned base = smem_u32(smem);
  const unsigned a[4] = {0x3f800000u, 0x3f800000u, 0u, 0u};
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_m64n64k8_tf32(d, a, kInterleave ? xt_desc(base + (ks & 3) * 256, 2048)
                                            : wgmma_desc(base + (ks & 3) * 32));
    wgmma_commit();
    wgmma_wait<0>();
  }
  float sum = 0.f;
  for (int i = 0; i < 32; ++i) sum += d[i];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}

// The TF32 wgrad kernel's tap loop alone: 2 warpgroups, each 5 taps an
// iteration (a segment), a tap a chain of 8 k steps into fresh accumulators
// (the first with scale-d false), waited for, then added to the tap's
// running sums in registers.
__global__ void __launch_bounds__(256, 1) wgmma_tf32_taps(float* out, int iters) {
  constexpr int kTaps = 5;
  __shared__ __align__(1024) unsigned char smem[16384];
  for (int i = threadIdx.x; i < 4096; i += 256)
    reinterpret_cast<float*>(smem)[i] = (i & 1) ? 1.f : 0.f;
  fence_proxy_async();
  __syncthreads();
  const unsigned base = smem_u32(smem);
  unsigned a[8][4];
  for (int ks = 0; ks < 8; ++ks) {
    a[ks][0] = a[ks][1] = 0x3f800000u + ks;
    a[ks][2] = a[ks][3] = 0u;
  }
  float acc[kTaps][32], fresh[32];
  for (int i = 0; i < 32; ++i) fresh[i] = 0.f;
  for (int t = 0; t < kTaps; ++t)
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const unsigned long long desc = wgmma_desc(base + ((t + it) & 1) * 1024);
      wgmma_fence();
      wgmma_m64n64k8_tf32_first(fresh, a[0], desc);
#pragma unroll
      for (int ks = 1; ks < 8; ++ks) wgmma_m64n64k8_tf32(fresh, a[ks], desc + (((ks & 3) * 32) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[t][i] += fresh[i];
    }
  }
  float sum = 0.f;
  for (int t = 0; t < kTaps; ++t)
    for (int i = 0; i < 32; ++i) sum += acc[t][i];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}

// 2 warpgroups, each 4 accumulator tiles of 64 x N, 4 k steps an iteration.
template <int N>
__global__ void __launch_bounds__(256, 1) wgmma_loop(float* out, int iters) {
  __shared__ __align__(1024) unsigned char smem[16384];
  for (int i = threadIdx.x; i < 4096; i += 256)
    reinterpret_cast<unsigned*>(smem)[i] = 0x3f803f80u * (i & 1);
  fence_proxy_async();
  __syncthreads();
  const unsigned base = smem_u32(smem);
  const unsigned a[4] = {0x3f803f80u, 0x3f803f80u, 0u, 0u};
  float d[4][N / 2];
  for (int m = 0; m < 4; ++m)
    for (int i = 0; i < N / 2; ++i) d[m][i] = 0.f;
  wgmma_fence();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if constexpr (N == 32) wgmma_m64n32k16(d[m], a, wgmma_desc(base + ks * 32));
        else wgmma_m64n64k16<1>(d[m], a, wgmma_desc(base + ks * 2048));
      }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float sum = 0.f;
  for (int m = 0; m < 4; ++m)
    for (int i = 0; i < N / 2; ++i) sum += d[m][i];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}

// 8 warps, each a 64 x 64 tile (4 x 8 m16n8 accumulators), 4 k steps an
// iteration; LD: 4 + 4 ldmatrix.x4 a k step for 32 mma.sync.
template <int LD>
__global__ void __launch_bounds__(256, 1) mma_loop(float* out, int iters) {
  __shared__ __align__(1024) unsigned char smem[32768];
  for (int i = threadIdx.x; i < 8192; i += 256)
    reinterpret_cast<unsigned*>(smem)[i] = 0x3f803f80u * (i & 1);
  __syncthreads();
  const unsigned base = smem_u32(smem);
  const int lane = threadIdx.x & 31;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lchunk = lane >> 4;
  float acc[4][8][4] = {};
  unsigned a[4][4], b[4][4];
  for (int m = 0; m < 4; ++m)
    for (int c = 0; c < 4; ++c) {
      a[m][c] = 0x3f803f80u;
      b[m][c] = 0x3f80u;
    }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (LD) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          ldsm_x4(a[m], base + swz128(m * 16 + lrow + (it & 7), ks * 2 + lchunk));
#pragma unroll
        for (int n = 0; n < 4; ++n)
          ldsm_x4_trans(b[n], base + 16384 + swz128(ks * 16 + lrow, n * 2 + lchunk));
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          mma_m16n8k16(acc[m][2 * n], a[m], b[n][0], b[n][1]);
          mma_m16n8k16(acc[m][2 * n + 1], a[m], b[n][2], b[n][3]);
        }
    }
  }
  float sum = 0.f;
  for (int m = 0; m < 4; ++m)
    for (int n = 0; n < 8; ++n)
      for (int c = 0; c < 4; ++c) sum += acc[m][n][c];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}

// FFMA on the CUDA cores: 4 warps a block (one a scheduler), each thread
// P x CT independent accumulators fed by P + CT register operands, as the
// float32 conv9 kernel's thread tile; P CT FFMA an iteration.
template <int P, int CT>
__global__ void __launch_bounds__(128) ffma_loop(float* out, int iters) {
  float xv[P], wv[CT], acc[P][CT];
  for (int j = 0; j < P; ++j) xv[j] = 1e-7f * (threadIdx.x + j);
  for (int c = 0; c < CT; ++c) wv[c] = 1.f - 1e-7f * c;
  for (int j = 0; j < P; ++j)
    for (int c = 0; c < CT; ++c) acc[j][c] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[j][c] = fmaf(xv[j], wv[c], acc[j][c]);
  }
  float sum = 0.f;
  for (int j = 0; j < P; ++j)
    for (int c = 0; c < CT; ++c) sum += acc[j][c];
  out[blockIdx.x * 128 + threadIdx.x] = sum;
}

}  // namespace

// mn_major: 0 bfloat16 K-major, 1 bfloat16 MN-major (m64n64k16; A 64 x 64,
// D 64 x 64); 2 TF32 K-major (m64n64k8; A 64 x 32, D 64 x 64); 3 the TF32
// wgrad form (A: X, R rows of 64 float32, R - 3 a multiple of 4; X: DY,
// 64 x 64; D 64 co x 64 ci).
SSHSLIE_EXPORT int probe_layout(int mn_major, const void* A, const void* X, void* D, int R, int s) {
  if (mn_major == 3) {
    const int smem = 4 * 8 * (R - 3) * 32 + R * 72 * 4 + 64 * 72 * 4;
    cudaError_t err = cudaFuncSetAttribute(tf32_wgrad_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tf32_wgrad_kernel<<<1, 128, smem>>>(static_cast<const float*>(A), static_cast<const float*>(X),
                                        static_cast<float*>(D), R, s);
    return static_cast<int>(cudaDeviceSynchronize());
  }
  const int smem = R * 128 + 1024;
  if (mn_major == 2) {
    cudaError_t err = cudaFuncSetAttribute(tf32_kmajor_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tf32_kmajor_kernel<<<1, 128, smem>>>(static_cast<const float*>(A), static_cast<const float*>(X),
                                         static_cast<float*>(D), R, s);
    return static_cast<int>(cudaDeviceSynchronize());
  }
  auto kernel = mn_major ? mnmajor_kernel : kmajor_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 128, smem>>>(static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(X),
                           static_cast<float*>(D), R, s);
  return static_cast<int>(cudaDeviceSynchronize());
}

// which: 0 wgmma m64n64k16, 1 wgmma m64n32k16, 2 mma.sync, 3 mma.sync + ldmatrix,
// 4 wgmma m64n32k8 .tf32, 5 wgmma m64n64k8 .tf32 (4 accumulators, B from row 0),
// 6 the same with 2 accumulators, 7 with 4 accumulators and B from row 3;
// 8, 9 a TF32 chain of 8 k steps waited for each iteration, B swizzled or
// not; 10 the TF32 wgrad kernel's tap loop; 11, 12, 13 FFMA with 16 x 4,
// 16 x 2 and 8 x 2 accumulators a thread, 128 threads a block.
SSHSLIE_EXPORT int probe_loop(int which, void* out, int blocks, int iters) {
  float* o = static_cast<float*>(out);
  switch (which) {
    case 0: wgmma_loop<64><<<blocks, 256>>>(o, iters); break;
    case 1: wgmma_loop<32><<<blocks, 256>>>(o, iters); break;
    case 2: mma_loop<0><<<blocks, 256>>>(o, iters); break;
    case 3: mma_loop<1><<<blocks, 256>>>(o, iters); break;
    case 4: wgmma_tf32_loop<32, 4, 0><<<blocks, 256>>>(o, iters); break;
    case 5: wgmma_tf32_loop<64, 4, 0><<<blocks, 256>>>(o, iters); break;
    case 6: wgmma_tf32_loop<64, 2, 0><<<blocks, 256>>>(o, iters); break;
    case 7: wgmma_tf32_loop<64, 4, 3><<<blocks, 256>>>(o, iters); break;
    case 8: wgmma_tf32_chains<0><<<blocks, 256>>>(o, iters); break;
    case 9: wgmma_tf32_chains<1><<<blocks, 256>>>(o, iters); break;
    case 10: wgmma_tf32_taps<<<blocks, 256>>>(o, iters); break;
    case 11: ffma_loop<16, 4><<<blocks, 128>>>(o, iters); break;
    case 12: ffma_loop<16, 2><<<blocks, 128>>>(o, iters); break;
    case 13: ffma_loop<8, 2><<<blocks, 128>>>(o, iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
