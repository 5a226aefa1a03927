// Shared plain-C helpers for the kernels of sshslie_torch.
//
// Every kernel library is a shared object with a plain C interface, loaded
// with ctypes (sshslie_torch/ops/_build.py). Each launch entry returns the
// cudaError_t of cudaGetLastError() right after the launch, so a refused
// launch (too much shared memory, a bad grid) reaches the Python wrapper as
// a non-zero code instead of passing silently.
//
// Each kernel that takes bfloat16 has its own entry beside the float32 one
// (suffix _bf16 / _f32); the wrapper picks it by the operands' dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SSHSLIE_EXPORT extern "C" __attribute__((visibility("default")))

// Four consecutive values of a float32 or bfloat16 array as a float4, and
// back. float32: one 16-byte access. bfloat16: one 8-byte access (the
// address must be 8-byte aligned), widened exactly (a bfloat16 is the top
// half of a float32) and narrowed with round-to-nearest-even. The kernels
// that take bfloat16 compute in float32 between the two.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// Name of a CUDA error code, for the wrapper's exception message.
SSHSLIE_EXPORT const char* sshslie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
