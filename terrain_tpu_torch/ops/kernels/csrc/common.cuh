// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four consecutive values at a shared-memory address (smem_u32) as fp32,
// 16 (fp32) or 8 (bf16) bytes aligned.  Loading through a 32-bit shared
// address keeps the compiler from rebuilding a generic pointer's shared
// window (S2R SR_CgaCtaId and ~10 instructions) at every predicated load.
template <typename T>
__device__ __forceinline__ void lds4(uint32_t a, float v[4]);
template <>
__device__ __forceinline__ void lds4<float>(uint32_t a, float v[4]) {
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(a));
}
template <>
__device__ __forceinline__ void lds4<__nv_bfloat16>(uint32_t a, float v[4]) {
  uint32_t lo, hi;
  asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n"
               : "=r"(lo), "=r"(hi)
               : "r"(a));
  v[0] = __uint_as_float(lo << 16);
  v[1] = __uint_as_float(lo & 0xffff0000u);
  v[2] = __uint_as_float(hi << 16);
  v[3] = __uint_as_float(hi & 0xffff0000u);
}

// A read-only load the compiler keeps where it is written: data loaded
// tiles ahead of its use (a plain load of read-only data may be moved down
// to the use; in a trial build of the stem's dW on the card that was
// slower).  bf16 comes back as fp32.
__device__ __forceinline__ float load_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float load_early(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, bypassing L1).  Both addresses must be 16-byte aligned.  With
// valid == false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One-thread 1-D bulk copies (the TMA unit) from device memory into shared
// memory, completing on an mbarrier: the issuing thread announces the bytes
// (mbar_expect_tx), the copies count them down, and waiters block on the
// barrier's phase parity.  Addresses 16-byte aligned, sizes multiples of 16.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// before a barrier's memory is used for anything else (no phase pending)
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// order this thread's earlier shared-memory accesses before later
// async-proxy (bulk copy) writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// TF32 tensor cores (mma.sync.m16n8k8): the value of v rounded to TF32
// (cvt.rna: to nearest, ties away), as the bit pattern mma reads; a value
// split hi + lo this way keeps 21 bits of its 24.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// Four 8x8 b16 matrices = for 32-bit data four 8-row x 4-column blocks; lane
// l gives the row address of block l/8 and receives, of each block i, row
// l/4, column l%4 in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// the same for two blocks: lanes 0..15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a (16x8, row) * b (8x8, col) in TF32 with fp32 accumulation
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Second pass of a reduction across blocks: out[i] = sum_p part[p][i] in a
// fixed order, so the result does not change from run to run (no atomics).
// Block b takes the 32 outputs b*32.. (one a lane, coalesced) and warp w
// the w-th eighth of the partials in block order; the eighths are then
// added in order.  Launch through sum_partials().
static __global__ void __launch_bounds__(256)
    sum_partials_kernel(const float* __restrict__ part,
                        float* __restrict__ out, int nparts, int len) {
  __shared__ float seg[8][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * 32 + lane;
  const int per = (nparts + 7) / 8;
  const int p1 = min(nparts, (w + 1) * per);
  float s = 0.f;
  if (i < len) {
#pragma unroll 4
    for (int p = w * per; p < p1; ++p) s += part[(size_t)p * len + i];
  }
  seg[w][lane] = s;
  __syncthreads();
  if (w != 0 || i >= len) return;
  float t = seg[0][lane];
#pragma unroll
  for (int k = 1; k < 8; ++k) t += seg[k][lane];
  out[i] = t;
}

static inline cudaError_t sum_partials(const float* part, float* out,
                                       int nparts, int len,
                                       cudaStream_t s) {
  sum_partials_kernel<<<(len + 31) / 32, 256, 0, s>>>(part, out, nparts,
                                                      len);
  return cudaGetLastError();
}

// Once per kernel, device and shared-memory size: the device's SM count and
// the blocks an SM holds; and the kernel's shared-memory allowance, raised
// when a launch needs more than any before.  A launch then makes no other
// runtime calls before the kernel's own.
static cudaError_t prepare(const void* kern, size_t smem, int threads,
                           int* sms, int* per_sm) {
  struct Entry {
    const void* kern;
    size_t smem;
    int dev, sms, per_sm;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  static std::vector<Entry> allowed;  // smem: the allowance set
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& x : seen)
    if (x.kern == kern && x.smem == smem && x.dev == dev) {
      *sms = x.sms;
      *per_sm = x.per_sm;
      return cudaSuccess;
    }
  size_t most = 0;
  for (const Entry& x : allowed)
    if (x.kern == kern && x.dev == dev && x.smem > most) most = x.smem;
  if (smem > most) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    allowed.push_back({kern, smem, dev, 0, 0});
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  seen.push_back({kern, smem, dev, *sms, *per_sm});
  return cudaSuccess;
}

// Every library exports <source>_error_string for its wrapper's messages.
#define DEFINE_ERROR_STRING(source)                          \
  extern "C" const char* source##_error_string(int e) {     \
    return cudaGetErrorString(static_cast<cudaError_t>(e)); \
  }
