// conv_thin: 3x3 stride-1 zero-padded convolution with few output channels.
//
// Replaces the TPU kernel terrain_tpu/ops/pallas/conv_thin.py
// (_fwd_kernel via _conv_thin_fwd_pallas / _thin_call), forward only.
//
//   y[n,h,w,o] = sum_{dy,dx,i} x[n,h+dy-1,w+dx-1,i] * w[dy,dx,i,o]
//   x: (N,H,W,C) NHWC, C <= 64;  w: (3,3,C,F) HWIO, F <= 8;  no bias.
//   Products of x.dtype values, summed in fp32; y in x.dtype.
//
// What bounds it on the card: bytes.  At (4,256,256,64) fp32 it reads
// 67 MB and writes 4.2 MB (about 21 us at 3.35 TB/s) for 1.2 GFLOP (about
// 18 us on the fp32 CUDA cores), and the 4 live output channels leave no
// room for tensor-core tiles.
//
// Design: the TPU kernel's W-on-lanes transposes and (1,7) edge padding
// exist for the (8,128) tiling and have no counterpart here.  Each block
// stages one (TH+2) x (TW+2) input tile with its 1-pixel halo in shared
// memory, reading every halo row as one contiguous, coalesced run of
// channels (NHWC rows are contiguous) and writing zeros outside the image
// (the conv's zero padding, computed from blockIdx).  The tile is stored
// channel-major with an odd plane stride, so the channel-fastest stores
// and the pixel-fastest reads are both free of bank conflicts.  The whole
// weight tensor (<= 9*64*8 floats) sits in shared memory and is read as a
// warp-wide broadcast.  Each thread produces all F outputs of one pixel in
// registers, so x is read from device memory once (plus the halo, which
// mostly hits L2) and y is written once.
#include "common.cuh"

namespace {

constexpr int TW = 32;  // output columns per block
constexpr int TH = 8;   // output rows per block
constexpr int HWC = TW + 2;
constexpr int HHR = TH + 2;
constexpr int PLANE = (HHR * HWC) | 1;  // odd: conflict-free channel stores
constexpr int NTHREADS = TW * TH;

template <typename T, int F>
__global__ void __launch_bounds__(NTHREADS)
    conv_thin_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int H, int W, int C) {
  extern __shared__ float smem[];
  float* sx = smem;               // [C][PLANE] input tile with halo
  float* sw = smem + C * PLANE;   // [9][C][F], the HWIO order
  const int n = blockIdx.z;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  for (int i = tid; i < 9 * C * F; i += NTHREADS) sw[i] = to_f(w[i]);
  const T* xn = x + (size_t)n * H * W * C;
  const int tile = HHR * HWC * C;
  for (int i = tid; i < tile; i += NTHREADS) {
    const int c = i % C;
    const int p = i / C;
    const int r = p / HWC;
    const int col = p - r * HWC;
    const int gh = h0 - 1 + r;
    const int gw = w0 - 1 + col;
    float v = 0.f;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W)
      v = to_f(xn[((size_t)gh * W + gw) * C + c]);
    sx[c * PLANE + r * HWC + col] = v;
  }
  __syncthreads();

  const int tx = tid % TW;
  const int ty = tid / TW;
  float acc[F];
#pragma unroll
  for (int o = 0; o < F; ++o) acc[o] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float* xs = sx + (ty + dy) * HWC + tx + dx;
      const float* ws = sw + (dy * 3 + dx) * C * F;
      for (int c = 0; c < C; ++c) {
        const float v = xs[c * PLANE];
#pragma unroll
        for (int o = 0; o < F; ++o) acc[o] = fmaf(v, ws[c * F + o], acc[o]);
      }
    }
  }
  const int gh = h0 + ty;
  const int gw = w0 + tx;
  if (gh < H && gw < W) {
    T* yp = y + (((size_t)n * H + gh) * W + gw) * F;
#pragma unroll
    for (int o = 0; o < F; ++o) yp[o] = from_f<T>(acc[o]);
  }
}

template <typename T, int F>
cudaError_t launch_t(const void* x, const void* w, void* y, int n, int h,
                     int wd, int c, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)c * PLANE + 9 * c * F);
  auto kern = conv_thin_kernel<T, F>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, n);
  kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(x),
                                         static_cast<const T*>(w),
                                         static_cast<T*>(y), h, wd, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f(const void* x, const void* w, void* y, int n, int h,
                     int wd, int c, int f, cudaStream_t s) {
  switch (f) {
    case 1: return launch_t<T, 1>(x, w, y, n, h, wd, c, s);
    case 2: return launch_t<T, 2>(x, w, y, n, h, wd, c, s);
    case 3: return launch_t<T, 3>(x, w, y, n, h, wd, c, s);
    case 4: return launch_t<T, 4>(x, w, y, n, h, wd, c, s);
    case 5: return launch_t<T, 5>(x, w, y, n, h, wd, c, s);
    case 6: return launch_t<T, 6>(x, w, y, n, h, wd, c, s);
    case 7: return launch_t<T, 7>(x, w, y, n, h, wd, c, s);
    case 8: return launch_t<T, 8>(x, w, y, n, h, wd, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

DEFINE_ERROR_STRING(conv_thin)

// x (n,h,wd,c) and y (n,h,wd,f) in `dtype`, w (3,3,c,f) in `dtype`; all
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int conv_thin_launch(const void* x, const void* w, void* y, int n,
                                int h, int wd, int c, int f, int dtype,
                                void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c > 64)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_f<float>(x, w, y, n, h, wd, c, f, s);
  if (dtype == kBF16)
    return launch_f<__nv_bfloat16>(x, w, y, n, h, wd, c, f, s);
  return cudaErrorInvalidValue;
}
