// bilinear_conv: bilinear x2 upsample fused with a 3x3 zero-padded conv, on
// Hopper's tensor cores.
//
// Replaces the TPU kernel terrain_tpu/ops/pallas/bilinear_conv.py
// (_kernel via _pallas_call / bilinear2x_conv3x3_pallas), forward only.
//
//   u = half-pixel bilinear x2 of x with edge clamp:
//       u[2j]   = 0.25*x[j-1] + 0.75*x[j]
//       u[2j+1] = 0.75*x[j]   + 0.25*x[j+1]     (indices clamped, per axis)
//   y[n,p,q,o] = b[o] + sum_{dy,dx,i} u[n,p+dy-1,q+dx-1,i] * w[dy,dx,i,o]
//       with u = 0 outside the 2H x 2W image (the conv's zero padding).
//   x: (N,H,W,C) NHWC, C % 8 == 0;  w: (3,3,C,F) HWIO in x.dtype, F % 8 == 0;
//   b: (F,) fp32.  Products fp32-accurate and sums in fp32 whatever the
//   input dtype, as the TPU kernel's f32 dot; bias added in fp32; y
//   (N,2H,2W,F) in x.dtype.  The 2x tensor u never reaches device memory.
//
// What bounds it on the card: operations.  Each flagship decoder stage
// ((N,64,64,512)->(N,128,128,128) and (N,128,128,256)->(N,256,256,64)) is
// 19.3 GFLOP per image against ~6-8 MB of traffic.  On the fp32 CUDA cores
// (67 TFLOP/s) that is 0.29 ms per image; on the TF32 tensor cores (495
// TFLOP/s) one pass takes 0.04 ms, but one TF32 pass rounds both factors to
// 11 significant bits, about 3e-4 x max|y| at K = 9*512, three times the
// 1e-4 the kernel is held to.  So the products are split (3xTF32): with
// every part rounded to TF32 by cvt.rna (round to nearest, ties away),
//   u = u_hi + u_lo,  w = w_hi + w_lo,
//   y ~= u_lo*w_hi + u_hi*w_lo + u_hi*w_hi      (u_lo*w_lo, ~2^-22, dropped)
// summed into one fp32 accumulator, the small terms first (the order of
// CUTLASS's 3xTF32 operators).  bf16 weights are exact in TF32, so bf16
// inputs take two passes, u_lo*w + u_hi*w: u, interpolated in fp32, is not.
// The fp32 bound is then three TF32 passes, 0.469 ms at batch 4 on either
// stage; bf16 work is bounded at the bf16 tensor cores' peak, 0.078 ms.
//
// Design: an implicit GEMM (M = output pixels, N = F, K = 9*C) on
// mma.sync.m16n8k8 tf32 with fp32 accumulators -- simpler than wgmma,
// whose tf32 form wants K-major operands in its canonical shared-memory
// layout, which a tap-shifted window of the upsampled tile is not.  A block
// owns a 16x16 output tile and 64 output channels of one image; its 8 warps
// are 4 (pixel rows) x 2 (channel halves), each warp 4 rows x 16 columns x
// 32 channels = 4x4 mma tiles, 64 accumulators a thread.  The input channels
// go by in chunks of 8 (one k8 step per tap):
//   1. cp.async has brought the chunk's 10x10 source halo (clamped indices:
//      the upsample's edge clamp) and its 9x8x64 weights into raw buffers;
//   2. the block builds the 18x18 upsampled tile (zeros outside the 2H x 2W
//      image) and splits it and the weights into hi/lo TF32 planes.  Both
//      planes keep K (the 8 channels) contiguous, so ldmatrix loads both
//      operands: a tap-shifted window of the tile is just other row
//      addresses.  A pixel's (or output channel's) row is padded from 8 to 12
//      floats, so the 8 rows of an ldmatrix phase fall in 8 distinct banks;
//   3. it issues the next chunk's copies, which land while it runs the 9
//      taps' products.
// Two blocks fit an SM (108 KB of shared memory in fp32, 70 KB in bf16, and
// at most 128 registers each), so one block's build overlaps the other's products.  No split-K:
// every output is summed by one thread in a fixed order, the same bits
// every run.
//
// The tensor cores add into the accumulator after aligning to its exponent
// and truncating, so the error on the card, ~3.4e-5 x max|y| at K = 9*512,
// is above the split's own (~5e-7, tests/test_torch_tf32_split.py) yet
// inside 1e-4, which a kernel without either cross term misses (~2e-4).  A
// second accumulator for the small terms gives ~1.2e-5 but takes ~240
// registers, one block an SM, and ~10% more time, so the kernel keeps one
// (terrain_tpu_torch/tools/bilinear_conv_variants.py builds those variants).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int OT = 16;             // output tile side (pixels of the 2x image)
constexpr int ST = OT / 2 + 2;     // source halo side (10)
constexpr int UT = OT + 2;         // upsampled tile side incl. conv halo (18)
constexpr int FT = 64;             // output channels per block
constexpr int CC = 8;              // input channels per chunk: one k8 step
constexpr int PS = 12;             // plane row stride: 8 channels + 4 pad
constexpr int NTHREADS = 256;      // 8 warps: 4 pixel-row groups x 2 halves
constexpr int U_FLOATS = UT * UT * PS;   // one plane of the upsampled tile
constexpr int W_FLOATS = 9 * FT * PS;    // one plane of the weights
constexpr int RAWW = 9 * CC * FT;        // raw weights of a chunk
constexpr int RAWS = ST * ST * CC;       // raw source halo of a chunk

// fp32 weights need a lo plane; bf16 weights are exact in TF32
template <typename T>
constexpr bool split_w = std::is_same<T, float>::value;

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * U_FLOATS + (split_w<T> ? 2 : 1) * W_FLOATS) +
         sizeof(T) * (RAWW + RAWS);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
    bilinear_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ b, T* __restrict__ y,
                         int H, int W, int C, int F, int n_ft) {
  constexpr bool kSplitW = split_w<T>;
  constexpr int EPC = 16 / sizeof(T);        // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* uhi = reinterpret_cast<float*>(smem_raw);   // [UT*UT][PS]
  float* ulo = uhi + U_FLOATS;
  float* whi = ulo + U_FLOATS;                       // [9][FT][PS]
  float* wlo = whi + W_FLOATS;                       // fp32 only
  T* raww = reinterpret_cast<T*>(whi + (kSplitW ? 2 : 1) * W_FLOATS);
  T* raws = raww + RAWW;                             // [ST*ST][CC]

  const int n = blockIdx.z / n_ft;
  const int f0 = (blockIdx.z % n_ft) * FT;
  const int oy0 = blockIdx.y * OT;
  const int ox0 = blockIdx.x * OT;
  const int sy0 = oy0 / 2 - 1;               // source row of raws row 0
  const int sx0 = ox0 / 2 - 1;
  const int H2 = 2 * H, W2 = 2 * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) & 3;             // tile rows wm*4 .. wm*4+3
  const int wn = tid >> 7;                   // channels wn*32 .. wn*32+31
  const T* xn = x + (size_t)n * H * W * C;

  // 1. the raw copies of the chunk at input channel c0
  auto issue = [&](int c0) {
    for (int i = tid; i < ST * ST * (CC / EPC); i += NTHREADS) {
      const int p = i / (CC / EPC);
      const int part = i - p * (CC / EPC);
      const int r = p / ST;
      const int q = p - r * ST;
      const int gy = min(max(sy0 + r, 0), H - 1);
      const int gx = min(max(sx0 + q, 0), W - 1);
      cp_async16(raws + p * CC + part * EPC,
                 xn + ((size_t)gy * W + gx) * C + c0 + part * EPC);
    }
    for (int i = tid; i < 9 * CC * (FT / EPC); i += NTHREADS) {
      const int row = i / (FT / EPC);        // tap * CC + channel
      const int part = i - row * (FT / EPC);
      const int tap = row / CC;
      const int f = f0 + part * EPC;
      const bool ok = f < F;                 // F % 8 == 0: whole pieces
      cp_async16(raww + row * FT + part * EPC,
                 ok ? w + ((size_t)tap * C + c0 + row - tap * CC) * F + f : w,
                 ok);
    }
    cp_async_commit();
  };

  // 2. hi/lo planes of the upsampled tile and of the weights
  auto build = [&]() {
    for (int i = tid; i < UT * UT * 2; i += NTHREADS) {
      const int cq = i / (UT * UT);          // which 4 of the 8 channels
      const int p = i - cq * (UT * UT);
      const int ur = p / UT;
      const int uc = p - ur * UT;
      const int gy = oy0 - 1 + ur;
      const int gx = ox0 - 1 + uc;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2) {
        const int jy = gy >> 1, jx = gx >> 1;
        // odd: 0.75*x[j] + 0.25*x[j+1]; even: 0.25*x[j-1] + 0.75*x[j]
        const int ra = ((gy & 1) ? jy : jy - 1) - sy0;
        const int ca = ((gx & 1) ? jx : jx - 1) - sx0;
        const float wra = (gy & 1) ? 0.75f : 0.25f;
        const float wca = (gx & 1) ? 0.75f : 0.25f;
        const T* s = raws + cq * 4;
        float s00[4], s01[4], s10[4], s11[4];
        load4(s + (ra * ST + ca) * CC, s00);
        load4(s + (ra * ST + ca + 1) * CC, s01);
        load4(s + ((ra + 1) * ST + ca) * CC, s10);
        load4(s + ((ra + 1) * ST + ca + 1) * CC, s11);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float top = wca * s00[k] + (1.f - wca) * s01[k];
          const float bot = wca * s10[k] + (1.f - wca) * s11[k];
          v[k] = wra * top + (1.f - wra) * bot;
        }
      }
      float hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hi[k] = tf32_rna(v[k]);
        lo[k] = tf32_rna(v[k] - hi[k]);
      }
      store4(uhi + p * PS + cq * 4, hi);
      store4(ulo + p * PS + cq * 4, lo);
    }
    // weights, transposed to [tap][f][c]
    for (int i = tid; i < 9 * 2 * FT; i += NTHREADS) {
      const int f = i % FT;
      const int r = i / FT;                  // tap * 2 + channel quad
      const int tap = r >> 1;
      const int cq = r & 1;
      float hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = to_f(raww[(tap * CC + cq * 4 + k) * FT + f]);
        hi[k] = kSplitW ? tf32_rna(v) : v;
        lo[k] = kSplitW ? tf32_rna(v - hi[k]) : 0.f;
      }
      store4(whi + (tap * FT + f) * PS + cq * 4, hi);
      if (kSplitW) store4(wlo + (tap * FT + f) * PS + cq * 4, lo);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  // ldmatrix row of this lane: A (16 pixels x 8 channels) blocks are
  // (px 0-7, c 0-3), (px 8-15, c 0-3), (px 0-7, c 4-7), (px 8-15, c 4-7)
  // = a0..a3; B blocks (f 0-7, c 0-3), (f 0-7, c 4-7), (f 8-15, c 0-3),
  // (f 8-15, c 4-7) = b0, b1 of two n8 tiles
  const int a_off = (lane & 15) * PS + (lane >> 4) * 4;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * PS +
                    ((lane >> 3) & 1) * 4;
  const float* ahi = uhi + wm * 4 * UT * PS + a_off;
  const float* alo = ulo + wm * 4 * UT * PS + a_off;
  const float* bhi = whi + wn * 32 * PS + b_off;
  const float* blo = wlo + wn * 32 * PS + b_off;

  const int nchunks = C / CC;
  issue(0);
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // the chunk has landed; the last chunk's planes are free
    build();
    __syncthreads();  // planes ready; the raw buffers are free
    if (ch + 1 < nchunks) issue((ch + 1) * CC);
    // unrolled by rows of taps: all nine at once spill at 128 registers
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldsm_x4(r, bhi + (tap * FT + jj * 16) * PS);
        bh[2 * jj][0] = r[0];
        bh[2 * jj][1] = r[1];
        bh[2 * jj + 1][0] = r[2];
        bh[2 * jj + 1][1] = r[3];
        if (kSplitW) {
          ldsm_x4(r, blo + (tap * FT + jj * 16) * PS);
          bl[2 * jj][0] = r[0];
          bl[2 * jj][1] = r[1];
          bl[2 * jj + 1][0] = r[2];
          bl[2 * jj + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = ((i + dy) * UT + dx) * PS;
        uint32_t ah[4], al[4];
        ldsm_x4(ah, ahi + off);
        ldsm_x4(al, alo + off);
        // pass by pass, the small terms first; consecutive mma independent
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al, bh[j]);
        if (kSplitW) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah, bl[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah, bh[j]);
      }
    }
  }

  // accumulator k of tile (i, j): pixel column g + 8*(k/2), channel 2t + k%2
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oy = oy0 + wm * 4 + i;
    if (oy >= H2) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + wn * 32 + j * 8 + 2 * t;
      if (f >= F) continue;                  // F even: f + 1 < F too
      const float b0 = b[f], b1 = b[f + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = ox0 + g + 8 * h;
        if (ox < W2)
          store2(y + (((size_t)n * H2 + oy) * W2 + ox) * F + f,
                 acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
      }
    }
  }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* w, const void* b, void* y,
                     int n, int h, int wd, int c, int f, cudaStream_t s) {
  const size_t smem = smem_bytes<T>();
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
// `dtype`; all contiguous, x and w 16-byte aligned; c % 8 == 0 and
// f % 8 == 0.  Returns cudaGetLastError() after the launch.
extern "C" int bilinear_conv_launch(const void* x, const void* w,
                                    const void* b, void* y, int n, int h,
                                    int wd, int c, int f, int dtype,
                                    void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || f <= 0 || c % 8 != 0 ||
      f % 8 != 0 || n * ((f + FT - 1) / FT) > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_t<float>(x, w, b, y, n, h, wd, c, f, s);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(x, w, b, y, n, h, wd, c, f, s);
  return cudaErrorInvalidValue;
}
