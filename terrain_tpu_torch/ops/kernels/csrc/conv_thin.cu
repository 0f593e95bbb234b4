// conv_thin: 3x3 stride-1 zero-padded convolution with few output channels.
//
// Replaces the TPU kernel terrain_tpu/ops/pallas/conv_thin.py
// (_fwd_kernel via _conv_thin_fwd_pallas / _thin_call), and its gradients:
//   conv_thin_dx_launch <- _conv_thin_dx_pallas (the forward body run with
//                          the channel roles swapped and rot180 weights)
//   conv_thin_dw_launch <- _dw_kernel via _conv_thin_dw_pallas
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
//
//   dX[n,h,w,i]  = sum_{dy,dx,o} g[n,h+1-dy,w+1-dx,o] * w[dy,dx,i,o]
//   dW[dy,dx,i,o] = sum_{n,h,w} x[n,h+dy-1,w+dx-1,i] * g[n,h,w,o]   (fp32)
// Both are bound by bytes too (the C-channel tensor is read or written
// once, about 71 MB at (4,256,256,64)x4).  dX stages the thin cotangent's
// halo tile the same way and gives each thread one pixel, 8 of the C
// outputs at a time, with the weights transposed in shared memory so that
// 8 outputs are two 16-byte broadcast loads.  dW: the TPU grid summed into
// one block in sequence; here a fixed number of blocks each walk a share of
// the tiles, a thread owns up to two (i,o) pairs x 9 taps in registers over
// all its tiles, each block writes one partial and sum_partials_kernel
// adds them in block order (no atomics: the same bits every run).
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

// Stage the (TH+2)x(TW+2) halo tile of an (H,W,C) image channel-major,
// zeros outside the image.
template <typename T>
__device__ __forceinline__ void stage_tile(float* sx, const T* xn, int h0,
                                           int w0, int H, int W, int C,
                                           int tid) {
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
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    conv_thin_dx_kernel(const T* __restrict__ g, const T* __restrict__ w,
                        T* __restrict__ dxo, int H, int W, int C, int F) {
  extern __shared__ __align__(16) float smem[];
  const int Cp = (C + 7) & ~7;
  float* swt = smem;                 // [9][F][Cp]: w[2-a,2-b,i,o] at (a,b,o,i)
  float* sg = smem + 9 * F * Cp;     // [F][PLANE] cotangent tile with halo
  const int n = blockIdx.z;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  for (int i = tid; i < 9 * F * Cp; i += NTHREADS) {
    const int c = i % Cp;
    const int o = (i / Cp) % F;
    const int tap = i / (Cp * F);
    const int a = tap / 3, b = tap - a * 3;
    float v = 0.f;
    if (c < C) v = to_f(w[(((2 - a) * 3 + (2 - b)) * C + c) * F + o]);
    swt[i] = v;
  }
  stage_tile(sg, g + (size_t)n * H * W * F, h0, w0, H, W, F, tid);
  __syncthreads();

  const int tx = tid % TW;
  const int ty = tid / TW;
  const int gh = h0 + ty;
  const int gw = w0 + tx;
  if (gh >= H || gw >= W) return;
  T* op = dxo + (((size_t)n * H + gh) * W + gw) * C;
  const bool vec = (C & 3) == 0;
  for (int c0 = 0; c0 < Cp; c0 += 8) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        for (int o = 0; o < F; ++o) {
          const float gv = sg[o * PLANE + (ty + a) * HWC + tx + b];
          const float4* wp = reinterpret_cast<const float4*>(
              swt + ((a * 3 + b) * F + o) * Cp + c0);
          const float4 wa = wp[0];
          const float4 wb = wp[1];
          acc[0] = fmaf(gv, wa.x, acc[0]);
          acc[1] = fmaf(gv, wa.y, acc[1]);
          acc[2] = fmaf(gv, wa.z, acc[2]);
          acc[3] = fmaf(gv, wa.w, acc[3]);
          acc[4] = fmaf(gv, wb.x, acc[4]);
          acc[5] = fmaf(gv, wb.y, acc[5]);
          acc[6] = fmaf(gv, wb.z, acc[6]);
          acc[7] = fmaf(gv, wb.w, acc[7]);
        }
    if (vec) {
      if (c0 < C) store4(op + c0, acc);
      if (c0 + 4 < C) store4(op + c0 + 4, acc + 4);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (c0 + k < C) op[c0 + k] = from_f<T>(acc[k]);
    }
  }
}

constexpr int PAIRS = 2;  // (i,o) pairs per thread: C*F <= PAIRS*NTHREADS

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    conv_thin_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        float* __restrict__ part, int H, int W, int C, int F,
                        int tiles_x, int tiles_y, int ntiles) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                 // [C][PLANE] input tile with halo
  float* sg = smem + C * PLANE;     // [TH*TW][F] cotangent tile
  const int tid = threadIdx.x;
  const int CF = C * F;
  float acc[PAIRS][9];
#pragma unroll
  for (int k = 0; k < PAIRS; ++k)
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[k][t] = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n = tile / (tiles_x * tiles_y);
    const int rem = tile - n * tiles_x * tiles_y;
    const int h0 = (rem / tiles_x) * TH;
    const int w0 = (rem % tiles_x) * TW;
    __syncthreads();
    stage_tile(sx, x + (size_t)n * H * W * C, h0, w0, H, W, C, tid);
    for (int i = tid; i < NTHREADS * F; i += NTHREADS) {
      const int p = i / F;
      const int gh = h0 + p / TW;
      const int gw = w0 + p % TW;
      float v = 0.f;
      if (gh < H && gw < W)
        v = to_f(g[(((size_t)n * H + gh) * W + gw) * F + (i - p * F)]);
      sg[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int pr = tid + k * NTHREADS;
      if (pr >= CF) continue;
      const int ci = pr / F;
      const int o = pr - ci * F;
      const float* xs = sx + ci * PLANE;
      for (int p = 0; p < NTHREADS; ++p) {
        const float gv = sg[p * F + o];
        const float* xp = xs + (p / TW) * HWC + (p % TW);
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            acc[k][a * 3 + b] = fmaf(xp[a * HWC + b], gv, acc[k][a * 3 + b]);
      }
    }
  }
  // partial in the HWIO order (tap, i, o)
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const int pr = tid + k * NTHREADS;
    if (pr >= CF) continue;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      part[(size_t)blockIdx.x * 9 * CF + t * CF + pr] = acc[k][t];
  }
}

template <typename T>
cudaError_t launch_dx(const void* g, const void* w, void* dx, int n, int h,
                      int wd, int c, int f, cudaStream_t s) {
  const int cp = (c + 7) & ~7;
  const size_t smem = sizeof(float) * ((size_t)9 * f * cp + (size_t)f * PLANE);
  auto kern = conv_thin_dx_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, n);
  kern<<<grid, NTHREADS, smem, s>>>(static_cast<const T*>(g),
                                    static_cast<const T*>(w),
                                    static_cast<T*>(dx), h, wd, c, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* g, void* part, void* dw,
                      int nblocks, int n, int h, int wd, int c, int f,
                      cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((size_t)c * PLANE + (size_t)NTHREADS * f);
  auto kern = conv_thin_dw_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tx = (wd + TW - 1) / TW, ty = (h + TH - 1) / TH;
  kern<<<nblocks, NTHREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(part), h, wd, c, f, tx, ty, n * tx * ty);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int len = 9 * c * f;
  sum_partials_kernel<<<(len + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), nblocks, len);
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

// g (n,h,wd,f) and dx (n,h,wd,c) in `dtype`, w (3,3,c,f) in `dtype`.
extern "C" int conv_thin_dx_launch(const void* g, const void* w, void* dx,
                                   int n, int h, int wd, int c, int f,
                                   int dtype, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || wd <= 0 || c <= 0 || c > 64 ||
      f <= 0 || f > 8)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_dx<float>(g, w, dx, n, h, wd, c, f, s);
  if (dtype == kBF16)
    return launch_dx<__nv_bfloat16>(g, w, dx, n, h, wd, c, f, s);
  return cudaErrorInvalidValue;
}

// x (n,h,wd,c) and g (n,h,wd,f) in `dtype`; part: fp32 scratch of
// nblocks*9*c*f; dw: fp32 (3,3,c,f).
extern "C" int conv_thin_dw_launch(const void* x, const void* g, void* part,
                                   void* dw, int nblocks, int n, int h,
                                   int wd, int c, int f, int dtype,
                                   void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c > 64 || f <= 0 || f > 8 ||
      nblocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_dw<float>(x, g, part, dw, nblocks, n, h, wd, c, f, s);
  if (dtype == kBF16)
    return launch_dw<__nv_bfloat16>(x, g, part, dw, nblocks, n, h, wd, c, f, s);
  return cudaErrorInvalidValue;
}
