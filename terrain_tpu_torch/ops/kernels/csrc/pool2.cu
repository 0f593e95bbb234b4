// pool2: 2x2 stride-2 max pool over NHWC tensors, forward and backward.
//
// Replaces the TPU kernels of terrain_tpu/ops/pallas/pool2.py:
//   pool2_fwd_launch <- _fwd_kernel via _fwd_call
//   pool2_bwd_launch <- _bwd_kernel via _bwd_call
//
//   window of output (n,i,j,c): a0 = x[n,2i,2j,c]   b0 = x[n,2i,2j+1,c]
//                               a1 = x[n,2i+1,2j,c] b1 = x[n,2i+1,2j+1,c]
//   m0 = max(a0,b0); m1 = max(a1,b1); y = max(m0,m1), compared in fp32 and
//   written in x's type (always exactly one of the four inputs).
//   backward: g goes to ONE element of the window, the first maximum in
//   row-major order: the even row wins when m0 >= m1, and inside the winning
//   row the even column wins when a >= b (pool2.py:84-94).  The other three
//   get 0.  dx is written whole by this kernel; nobody zero-fills it first.
//
// NaN: max() here returns NaN when either operand is NaN (as jnp.maximum and
// torch.maximum do), so the forward propagates NaN; `>=` is false for NaN, so
// the backward then sends g to the later element.  The plain PyTorch version
// (ops/kernels/pool2.py) does the same.
//
// What bounds them on the card: bytes.  The forward reads x once and writes a
// quarter of it; the backward reads x and g and writes dx.  There is no reuse
// to exploit, so the design is only about whole-line traffic: a thread owns 4
// consecutive channels (one 16-byte load in fp32) of one output pixel,
// neighbouring threads own neighbouring channels, then neighbouring pixels of
// a row, so a warp's loads and stores are runs of whole 128-byte lines.  The
// TPU kernel's (n,h/2,2,w/2,2c) lane view and its row blocks exist only for
// Mosaic's tiling and have no counterpart here.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a >= b || a != a) ? a : b;
}

struct Window {
  size_t x00;   // offset of x[n,2i,2j,c4]
  size_t row;   // W*C
  size_t out;   // offset of y[n,i,j,c4]
};

__device__ __forceinline__ bool locate(size_t idx, int H, int W, int C,
                                       size_t total, Window* wd) {
  if (idx >= total) return false;
  const int CQ = C / 4;
  const int W2 = W / 2, H2 = H / 2;
  const int cq = (int)(idx % CQ);
  size_t r = idx / CQ;
  const int j = (int)(r % W2);
  r /= W2;
  const int i = (int)(r % H2);
  const size_t n = r / H2;
  wd->row = (size_t)W * C;
  wd->x00 = ((n * H + 2 * i) * W + 2 * j) * (size_t)C + cq * 4;
  wd->out = ((n * H2 + i) * W2 + j) * (size_t)C + cq * 4;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    pool2_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W,
                     int C, size_t total) {
  Window wd;
  if (!locate((size_t)blockIdx.x * NT + threadIdx.x, H, W, C, total, &wd))
    return;
  float a0[4], b0[4], a1[4], b1[4], o[4];
  load4(x + wd.x00, a0);
  load4(x + wd.x00 + C, b0);
  load4(x + wd.x00 + wd.row, a1);
  load4(x + wd.x00 + wd.row + C, b1);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = max_nan(max_nan(a0[k], b0[k]), max_nan(a1[k], b1[k]));
  store4(y + wd.out, o);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    pool2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     T* __restrict__ dx, int H, int W, int C, size_t total) {
  Window wd;
  if (!locate((size_t)blockIdx.x * NT + threadIdx.x, H, W, C, total, &wd))
    return;
  float a0[4], b0[4], a1[4], b1[4], gv[4];
  load4(x + wd.x00, a0);
  load4(x + wd.x00 + C, b0);
  load4(x + wd.x00 + wd.row, a1);
  load4(x + wd.x00 + wd.row + C, b1);
  load4(g + wd.out, gv);
  float d00[4], d01[4], d10[4], d11[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hm = max_nan(a0[k], b0[k]) >= max_nan(a1[k], b1[k]);
    const float de = hm ? gv[k] : 0.f;
    const float dodd = hm ? 0.f : gv[k];
    const bool we = a0[k] >= b0[k];
    const bool wo = a1[k] >= b1[k];
    d00[k] = we ? de : 0.f;
    d01[k] = we ? 0.f : de;
    d10[k] = wo ? dodd : 0.f;
    d11[k] = wo ? 0.f : dodd;
  }
  store4(dx + wd.x00, d00);
  store4(dx + wd.x00 + C, d01);
  store4(dx + wd.x00 + wd.row, d10);
  store4(dx + wd.x00 + wd.row + C, d11);
}

bool bad_shape(int n, int h, int w, int c) {
  return n <= 0 || h <= 0 || w <= 0 || c <= 0 || h % 2 != 0 || w % 2 != 0 ||
         c % 4 != 0;
}

size_t threads_total(int n, int h, int w, int c) {
  return (size_t)n * (h / 2) * (w / 2) * (c / 4);
}

template <typename T>
cudaError_t fwd_t(const void* x, void* y, int n, int h, int w, int c,
                  cudaStream_t s) {
  const size_t total = threads_total(n, h, w, c);
  const size_t blocks = (total + NT - 1) / NT;
  if (blocks > 2147483647u) return cudaErrorInvalidValue;
  pool2_fwd_kernel<T><<<(unsigned)blocks, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), h, w, c, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_t(const void* x, const void* g, void* dx, int n, int h, int w,
                  int c, cudaStream_t s) {
  const size_t total = threads_total(n, h, w, c);
  const size_t blocks = (total + NT - 1) / NT;
  if (blocks > 2147483647u) return cudaErrorInvalidValue;
  pool2_bwd_kernel<T><<<(unsigned)blocks, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      h, w, c, total);
  return cudaGetLastError();
}

}  // namespace

DEFINE_ERROR_STRING(pool2)

// x (n,h,w,c) -> y (n,h/2,w/2,c), both in `dtype`, contiguous; h, w even,
// c a multiple of 4.  Returns cudaGetLastError() after the launch.
extern "C" int pool2_fwd_launch(const void* x, void* y, int n, int h, int w,
                                int c, int dtype, void* stream) {
  if (bad_shape(n, h, w, c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return fwd_t<float>(x, y, n, h, w, c, s);
  if (dtype == kBF16) return fwd_t<__nv_bfloat16>(x, y, n, h, w, c, s);
  return cudaErrorInvalidValue;
}

// x and dx (n,h,w,c), g (n,h/2,w/2,c), all in `dtype`, contiguous.
extern "C" int pool2_bwd_launch(const void* x, const void* g, void* dx, int n,
                                int h, int w, int c, int dtype, void* stream) {
  if (bad_shape(n, h, w, c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return bwd_t<float>(x, g, dx, n, h, w, c, s);
  if (dtype == kBF16) return bwd_t<__nv_bfloat16>(x, g, dx, n, h, w, c, s);
  return cudaErrorInvalidValue;
}
