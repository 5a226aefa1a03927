// Tensor-core building blocks of the bfloat16 kernels (conv9.cu,
// conv9_wgrad.cu, flash_attn.cu): cp.async copies into shared memory,
// ldmatrix loads of fragments, mma.sync m16n8k16 (flash attention), and
// wgmma (m64nNk16, bfloat16 operands, float32 accumulators) with B read
// from shared memory through a descriptor (the conv kernels).
//
// Shared-memory layout the conv kernels assume: rows of 128 bytes (64 bfloat16, one
// pixel's channels or one input channel's 64 output channels), each row
// eight 16-byte chunks, chunk c of row r stored at chunk c ^ (r & 7). That
// is wgmma's 128-byte swizzle when the tile starts on a 1024-byte boundary.
// Eight lanes of an ldmatrix read one chunk of eight consecutive rows,
// which the XOR spreads over the eight 16-byte bank groups: no bank
// conflicts at any row offset (any tap shift).
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of 128-byte row `row`, swizzled.
__device__ __forceinline__ unsigned swz128(int row, int chunk) {
  return static_cast<unsigned>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0 writes
// zeros (the padding outside the image) and reads nothing.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bfloat16 matrices: lane l gives the address of row l % 8 (16
// bytes) of matrix l / 8, and register i receives matrix i's fragment: lane
// l holds row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 (the lower one in
// the low half).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed on the way: lane l holds rows 2 (l % 4)
// and 2 (l % 4) + 1 of column l / 4.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- mma.sync m16n8k16 (one warp) ----
//
// d (16 x 8, float32) += a (16 x 16 bfloat16) * b (16 x 8 bfloat16). With
// g = lane / 4 and t = lane % 4: a[0] holds row g, columns 2t and 2t+1;
// a[1] row g+8; a[2] row g, columns 2t+8 and 2t+9; a[3] row g+8, the same.
// b0 holds rows (k) 2t and 2t+1 of column (n) g, b1 rows 2t+8 and 2t+9.
// d[0], d[1] are row g, columns 2t and 2t+1; d[2], d[3] row g+8.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- wgmma (a warpgroup of 4 warps, asynchronous) ----
//
// A comes from registers, in the mma.sync m16n8k16 A-fragment layout, warp
// w of the warpgroup holding rows 16w .. 16w+15. B is read by the tensor
// cores from shared memory through a matrix descriptor. The accumulator
// fragment is the m16n8 layout of each warp's 16 rows, n8 block by n8 block.

// Descriptor of a B operand in the 128-byte-swizzled layout above: start
// address, 8-row groups 1024 bytes apart. The swizzle is applied to the
// absolute address bits, so the start may be any 16-byte-aligned row and
// chunk of a tile whose base is 1024-byte aligned: a K-major B (rows are
// n, 64 k each) may start at any row, which is how a tap's shifted pixel
// window is addressed; the k step within a row is +32 bytes.
__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>(1) << 16) |          // leading offset (unused)
         (static_cast<unsigned long long>(1024 >> 4) << 32) |  // stride offset
         (static_cast<unsigned long long>(1) << 62);           // 128-byte swizzle
}

// Orders this thread's register writes (A fragments, accumulators) before
// the wgmma that reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define SSHSLIE_ACC16(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])

// d (64 x 64, float32) += a (64 x 16 bfloat16, registers) * B (16 x 64 in
// shared memory at desc): K-major (64 rows of n, 16 k each) or, with
// kMnMajor, MN-major (16 rows of k, 64 n each). Either may start at any row.
template <int kMnMajor>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const unsigned (&a)[4],
                                                unsigned long long desc) {
  float* e = d + 16;
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, %37;\n"
      : SSHSLIE_ACC16(d), SSHSLIE_ACC16(e)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kMnMajor));
}
