// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Four consecutive values as fp32.  p must be aligned to 4 elements.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&a);
  raw.y = *reinterpret_cast<const unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Second pass of a reduction across blocks: out[i] = sum_p part[p][i], the
// partials summed in block order, so the result does not change from run
// to run (no atomics).
static __global__ void sum_partials_kernel(const float* __restrict__ part,
                                           float* __restrict__ out,
                                           int nparts, int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[(size_t)p * len + i];
  out[i] = s;
}

// Every library exports <source>_error_string for its wrapper's messages.
#define DEFINE_ERROR_STRING(source)                          \
  extern "C" const char* source##_error_string(int e) {     \
    return cudaGetErrorString(static_cast<cudaError_t>(e)); \
  }
