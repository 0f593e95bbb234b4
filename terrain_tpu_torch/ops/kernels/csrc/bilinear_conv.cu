// bilinear_conv: bilinear x2 upsample fused with a 3x3 zero-padded conv.
//
// Replaces the TPU kernel terrain_tpu/ops/pallas/bilinear_conv.py
// (_kernel via _pallas_call / bilinear2x_conv3x3_pallas), forward only.
//
//   u = half-pixel bilinear x2 of x with edge clamp:
//       u[2j]   = 0.25*x[j-1] + 0.75*x[j]
//       u[2j+1] = 0.75*x[j]   + 0.25*x[j+1]     (indices clamped, per axis)
//   y[n,p,q,o] = b[o] + sum_{dy,dx,i} u[n,p+dy-1,q+dx-1,i] * w[dy,dx,i,o]
//       with u = 0 outside the 2H x 2W image (the conv's zero padding).
//   x: (N,H,W,C) NHWC;  w: (3,3,C,F) HWIO in x.dtype;  b: (F,) fp32.
//   All arithmetic in fp32 whatever the input dtype, as the TPU kernel
//   does; y (N,2H,2W,F) in x.dtype.  The 2x tensor u never reaches device
//   memory.
//
// What bounds it on the card: operations.  Each flagship decoder stage
// ((N,64,64,512)->(N,128,128,128) and (N,128,128,256)->(N,256,256,64)) is
// 19.3 GFLOP per image against ~6-8 MB of traffic: about 0.29 ms per image
// on the 67 TFLOP/s fp32 CUDA cores, far above the memory time.
//
// Design: the TPU kernel's edge pad (1,7) and (8,128)-aligned DMA windows
// are replaced by indices computed from blockIdx.  One block owns a 16x16
// output tile and 64 output channels of one image, and loops over input
// channels in chunks of 16:
//   1. it loads the 10x10 source halo of the chunk with clamped indices
//      (which is the upsample's edge clamp) and the chunk's weights;
//   2. it builds the 18x18 upsampled tile (1-pixel conv halo) in shared
//      memory, with zeros outside the 2H x 2W image;
//   3. it accumulates the 9 taps into registers.
// Being compute bound, the design is a register-blocked product on the
// CUDA cores: each thread keeps an 8-pixel x 8-channel fp32 accumulator,
// so every shared-memory load feeds 6.4 FMAs on average.  A warp owns one
// group of 8 output channels (its weight reads are broadcasts) and 16
// columns x 2 row-groups of pixels, a mapping whose upsampled-tile reads
// hit 32 distinct banks.
#include "common.cuh"

namespace {

constexpr int OT = 16;           // output tile: OT x OT pixels of the 2x image
constexpr int FT = 64;           // output channels per block
constexpr int CC = 16;           // input channels per chunk
constexpr int ST = OT / 2 + 2;   // source tile side incl. halo (10)
constexpr int UT = OT + 2;       // upsampled tile side incl. conv halo (18)
constexpr int RM = 8;            // output rows per thread
constexpr int NTHREADS = 256;    // 8 warps = 8 channel groups of 8
constexpr int SMEM_FLOATS = CC * ST * ST + CC * UT * UT + 9 * CC * FT;

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
    bilinear_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ b, T* __restrict__ y,
                         int H, int W, int C, int F, int n_ft) {
  extern __shared__ __align__(16) float smem[];
  float* ss = smem;                          // [CC][ST*ST] source, clamped
  float* su = ss + CC * ST * ST;             // [CC][UT*UT] upsampled tile
  float* sw = su + CC * UT * UT;             // [9][CC][FT] weights

  const int n = blockIdx.z / n_ft;
  const int f0 = (blockIdx.z % n_ft) * FT;
  const int oy0 = blockIdx.y * OT;
  const int ox0 = blockIdx.x * OT;
  const int sy0 = oy0 / 2 - 1;               // source row of ss row 0
  const int sx0 = ox0 / 2 - 1;
  const int H2 = 2 * H, W2 = 2 * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = tid >> 5;                   // channel group 0..7
  const int col = lane & 15;
  const int r0 = (lane >> 4) * RM;           // first output row of thread

  const T* xn = x + (size_t)n * H * W * C;
  float acc[RM][8];
#pragma unroll
  for (int j = 0; j < RM; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    // 1. source halo (clamped = the upsample's edge clamp) and weights
    for (int i = tid; i < CC * ST * ST; i += NTHREADS) {
      const int c = i % CC;
      const int p = i / CC;
      const int r = p / ST;
      const int q = p - r * ST;
      const int gy = min(max(sy0 + r, 0), H - 1);
      const int gx = min(max(sx0 + q, 0), W - 1);
      float v = 0.f;
      if (c0 + c < C) v = to_f(xn[((size_t)gy * W + gx) * C + c0 + c]);
      ss[c * ST * ST + p] = v;
    }
    for (int i = tid; i < 9 * CC * FT; i += NTHREADS) {
      const int f = i % FT;
      const int c = (i / FT) % CC;
      const int tap = i / (FT * CC);
      float v = 0.f;
      if (c0 + c < C && f0 + f < F)
        v = to_f(w[((size_t)tap * C + c0 + c) * F + f0 + f]);
      sw[i] = v;
    }
    __syncthreads();
    // 2. upsampled tile with the conv's zero halo outside the 2x image
    for (int i = tid; i < CC * UT * UT; i += NTHREADS) {
      const int c = i / (UT * UT);
      const int p = i - c * (UT * UT);
      const int ur = p / UT;
      const int uc = p - ur * UT;
      const int gy = oy0 - 1 + ur;
      const int gx = ox0 - 1 + uc;
      float v = 0.f;
      if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2) {
        const int jy = gy >> 1, jx = gx >> 1;
        // odd: 0.75*x[j] + 0.25*x[j+1]; even: 0.25*x[j-1] + 0.75*x[j]
        const int ra = ((gy & 1) ? jy : jy - 1) - sy0;
        const int ca = ((gx & 1) ? jx : jx - 1) - sx0;
        const float wra = (gy & 1) ? 0.75f : 0.25f;
        const float wca = (gx & 1) ? 0.75f : 0.25f;
        const float* s = ss + c * ST * ST;
        const float top = wca * s[ra * ST + ca] + (1.f - wca) * s[ra * ST + ca + 1];
        const float bot = wca * s[(ra + 1) * ST + ca] +
                          (1.f - wca) * s[(ra + 1) * ST + ca + 1];
        v = wra * top + (1.f - wra) * bot;
      }
      su[i] = v;
    }
    __syncthreads();
    // 3. nine taps into the 8x8 register accumulator
    for (int c = 0; c < CC; ++c) {
      const float* uc = su + c * UT * UT + r0 * UT + col;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float u[RM + 2];
#pragma unroll
        for (int i = 0; i < RM + 2; ++i) u[i] = uc[i * UT + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4* wp = reinterpret_cast<const float4*>(
              sw + ((dy * 3 + dx) * CC + c) * FT + cg * 8);
          const float4 wa = wp[0];
          const float4 wb = wp[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < RM; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k)
              acc[j][k] = fmaf(u[j + dy], wv[k], acc[j][k]);
        }
      }
    }
    __syncthreads();
  }

  const int ox = ox0 + col;
  const int fb = f0 + cg * 8;
  if (ox >= W2 || fb >= F) return;
#pragma unroll
  for (int j = 0; j < RM; ++j) {
    const int oy = oy0 + r0 + j;
    if (oy >= H2) break;
    T* yp = y + (((size_t)n * H2 + oy) * W2 + ox) * F + fb;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (fb + k < F) yp[k] = from_f<T>(acc[j][k] + b[fb + k]);
  }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* w, const void* b, void* y,
                     int n, int h, int wd, int c, int f, cudaStream_t s) {
  const size_t smem = sizeof(float) * SMEM_FLOATS;
  auto kern = bilinear_conv_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n_ft = (f + FT - 1) / FT;
  dim3 grid((2 * wd + OT - 1) / OT, (2 * h + OT - 1) / OT, n * n_ft);
  kern<<<grid, NTHREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), h, wd, c, f, n_ft);
  return cudaGetLastError();
}

}  // namespace

DEFINE_ERROR_STRING(bilinear_conv)

// x (n,h,wd,c) and w (3,3,c,f) in `dtype`, b (f,) fp32, y (n,2h,2wd,f) in
// `dtype`; all contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int bilinear_conv_launch(const void* x, const void* w,
                                    const void* b, void* y, int n, int h,
                                    int wd, int c, int f, int dtype,
                                    void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || f <= 0 || f % 8 != 0 ||
      n * ((f + FT - 1) / FT) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_t<float>(x, w, b, y, n, h, wd, c, f, s);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(x, w, b, y, n, h, wd, c, f, s);
  return cudaErrorInvalidValue;
}
