// bilinear: bilinear x2 upsample with half-pixel centres and edge clamp,
// NHWC, fp32.
//
// Replaces the TPU kernel of terrain_tpu/ops/pallas/bilinear.py:
//   bilinear_2x_launch <- _kernel via _pallas_bilinear_2x (bilinear_2x_pallas)
//
//   rows first:   r[2i]   = 0.25*x[i-1] + 0.75*x[i]
//                 r[2i+1] = 0.75*x[i]   + 0.25*x[i+1]
//   then columns of r the same way; indices clamped at the edges.  Every
//   product and every sum is rounded on its own (__fmul_rn / __fadd_rn, so
//   nvcc contracts nothing into an FMA), in the order of the plain PyTorch
//   version (ops/kernels/bilinear.py), so the two agree bit for bit.
//
// The backward is the linear transpose and is PyTorch code, as it is XLA
// code in the JAX package (bilinear.py:133-137): no kernel here.
//
// What bounds it on the card: bytes.  It reads the input once and writes
// four times as much; there is no arithmetic to speak of.  A thread owns 4
// consecutive channels (one 16-byte load) of one input pixel and writes
// that pixel's 2x2 output block (four 16-byte stores); neighbouring threads
// own neighbouring channels, then neighbouring pixels of a row, so a warp's
// loads and stores are runs of whole 128-byte lines.  The 3x3 neighbourhood
// a thread reads is read by the threads of the neighbouring pixels too; those
// re-reads hit L1/L2, and device memory sees each input byte about once.
// The TPU kernel's (HT+8, WT+8) halo window and its manual DMA exist for
// Mosaic's (8, 128) tiling and have no counterpart here.
#include "common.cuh"

namespace {

constexpr int NT = 256;

// 0.25*prev + 0.75*cur and 0.75*cur + 0.25*next, each term rounded
__device__ __forceinline__ float lerp_lo(float prev, float cur) {
  return __fadd_rn(__fmul_rn(0.25f, prev), __fmul_rn(0.75f, cur));
}
__device__ __forceinline__ float lerp_hi(float cur, float next) {
  return __fadd_rn(__fmul_rn(0.75f, cur), __fmul_rn(0.25f, next));
}

__global__ void __launch_bounds__(NT)
    bilinear_2x_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int H, int W, int C, size_t total) {
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= total) return;
  const int CQ = C / 4;
  const int cq = (int)(idx % CQ);
  size_t r = idx / CQ;
  const int j = (int)(r % W);
  r /= W;
  const int i = (int)(r % H);
  const size_t n = r / H;

  const int rows[3] = {max(i - 1, 0), i, min(i + 1, H - 1)};
  const int cols[3] = {max(j - 1, 0), j, min(j + 1, W - 1)};
  const float* xn = x + n * H * W * (size_t)C + cq * 4;

  // rows first: the even and odd output row at each of the three columns
  float re[3][4], ro[3][4];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    float p[4], c[4], q[4];
    load4(xn + ((size_t)rows[0] * W + cols[b]) * C, p);
    load4(xn + ((size_t)rows[1] * W + cols[b]) * C, c);
    load4(xn + ((size_t)rows[2] * W + cols[b]) * C, q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      re[b][k] = lerp_lo(p[k], c[k]);
      ro[b][k] = lerp_hi(c[k], q[k]);
    }
  }
  // then columns
  float o00[4], o01[4], o10[4], o11[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o00[k] = lerp_lo(re[0][k], re[1][k]);
    o01[k] = lerp_hi(re[1][k], re[2][k]);
    o10[k] = lerp_lo(ro[0][k], ro[1][k]);
    o11[k] = lerp_hi(ro[1][k], ro[2][k]);
  }
  const size_t row = 2 * (size_t)W * C;  // one output row
  float* yo = y + ((n * 2 * H + 2 * i) * 2 * W + 2 * j) * (size_t)C + cq * 4;
  store4(yo, o00);
  store4(yo + C, o01);
  store4(yo + row, o10);
  store4(yo + row + C, o11);
}

}  // namespace

DEFINE_ERROR_STRING(bilinear)

// x (n,h,w,c) -> y (n,2h,2w,c), fp32, contiguous, 16-byte aligned; c a
// multiple of 4.  Returns cudaGetLastError() after the launch.
extern "C" int bilinear_2x_launch(const void* x, void* y, int n, int h,
                                  int w, int c, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 4 != 0)
    return cudaErrorInvalidValue;
  const size_t total = (size_t)n * h * w * (c / 4);
  const size_t blocks = (total + NT - 1) / NT;
  if (blocks > 2147483647u) return cudaErrorInvalidValue;
  bilinear_2x_kernel<<<(unsigned)blocks, NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), h, w, c, total);
  return cudaGetLastError();
}
