// Probe of the H100's tensor-core forms for the bfloat16 conv kernels
// (run by tc_probe.py):
//   * layout checks of the wgmma helper in ../csrc/mma.cuh (m64n64k16): a
//     K-major B (conv9.cu) and an MN-major B (conv9_wgrad.cu) read through
//     a descriptor that starts at an arbitrary row of a 128-byte-swizzled
//     tile, as the conv kernels address a tap's shifted pixel window;
//   * throughput of mma.sync m16n8k16 (with and without the ldmatrix loads
//     of a 64 x 64 warp tile; both helpers from mma.cuh, as flash_attn.cu
//     uses them) and of wgmma with A from registers, in loops on data
//     already in shared memory and registers.
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

// X (R rows of 64 bfloat16) into a swizzled tile at a 1024-byte boundary.
__device__ unsigned stage_rows(unsigned char* smem, const __nv_bfloat16* X, int R) {
  const unsigned xs = (smem_u32(smem) + 1023) & ~1023u;
  for (int i = threadIdx.x; i < R * 8; i += blockDim.x)
    cp_async16(xs + swz128(i >> 3, i & 7), X + (i >> 3) * 64 + (i & 7) * 8, 16);
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

}  // namespace

SSHSLIE_EXPORT int probe_layout(int mn_major, const void* A, const void* X, void* D, int R, int s) {
  const int smem = R * 128 + 1024;
  auto kernel = mn_major ? mnmajor_kernel : kmajor_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 128, smem>>>(static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(X),
                           static_cast<float*>(D), R, s);
  return static_cast<int>(cudaDeviceSynchronize());
}

// which: 0 wgmma m64n64k16, 1 wgmma m64n32k16, 2 mma.sync, 3 mma.sync + ldmatrix.
SSHSLIE_EXPORT int probe_loop(int which, void* out, int blocks, int iters) {
  float* o = static_cast<float*>(out);
  switch (which) {
    case 0: wgmma_loop<64><<<blocks, 256>>>(o, iters); break;
    case 1: wgmma_loop<32><<<blocks, 256>>>(o, iters); break;
    case 2: mma_loop<0><<<blocks, 256>>>(o, iters); break;
    case 3: mma_loop<1><<<blocks, 256>>>(o, iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
