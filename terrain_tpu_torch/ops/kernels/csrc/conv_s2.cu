// conv_s2: 3x3 stride-2 convolution with symmetric padding 1 of an image with
// few channels (cin 1, 2 or 4) into F feature maps, with bias and an optional
// LeakyReLU epilogue, and its weight/bias gradient kernel.
//
// Replaces the TPU kernels of terrain_tpu/ops/pallas/conv_s2.py:
//   conv_s2_fwd_launch <- _fwd_kernel via _conv_s2_fwd_pallas
//   conv_s2_dw_launch  <- _dw_kernel  via _conv_s2_dw_pallas (dW + db)
// (dX is no TPU kernel there either: it stays a library transposed conv.)
//
//   y[n,oy,ox,f] = act(b[f] + sum_{dy,dx,ci} x[n,2oy+dy-1,2ox+dx-1,ci]
//                                            * w[dy,dx,ci,f])
//                  act(v) = max(v, slope*v) when a slope is given
//   gm           = g where the saved y >= 0, else slope*g   (with a slope)
//   dW[dy,dx,ci,f] = sum_{n,oy,ox} x[n,2oy+dy-1,2ox+dx-1,ci] * gm[n,oy,ox,f]
//   db[f]          = sum_{n,oy,ox} gm[n,oy,ox,f]
//   x (N,H,W,cin), w (3,3,cin,F), y and g (N,H/2,W/2,F) in `dtype`; b, dW, db
//   fp32.  Products and sums in fp32 whatever the input type.  The padding is
//   one row and one column on BOTH sides (Lasagne 'same'); with H and W even
//   only the low side is ever read.
//
// What bounds them on the card: bytes.  At the U-Net's first conv
// (4,512,512,1) -> 64 the forward reads 4 MB and writes 67 MB; at PatchGAN's
// (8,512,512,4) -> 64 it reads 34 MB and writes 134 MB; dW reads g and, with a
// slope, the saved y.  The arithmetic (9*cin FMAs per output value) is far
// below the fp32 peak.
//
// Design: the TPU kernel's plane stack (column-subsampled copies of x made
// outside the kernel), its 8-aligned halo DMA and its one-dot-per-row loop
// exist for Mosaic's lane rules and the MXU.  Here a block stages the
// (2*TH+1) x (2*TW+1) x cin halo tile of x once into shared memory, one plane
// per channel, the stride-2 taps are plain shared-memory reads, and the F
// axis stays on neighbouring threads, 4 values (16 bytes) a thread, so every
// store of y and every load of g/y is a run of whole 128-byte lines.
//   fwd: the 9*cin x F weights sit in shared memory; a thread owns 8 pixels
//        of an output row x 4 features in registers, so one weight load feeds
//        32 FMAs.
//   dW:  blocks run in any order (the TPU grid accumulated in sequence), so a
//        fixed number of blocks each walk a share of the tiles.  A thread owns
//        4 features of ONE input channel: 9 taps x 4 features in registers
//        (36, where all channels together would need 144 and spill), over all
//        its pixels.  The block reduces over its threads in shared memory in a
//        fixed order and writes one partial; sum_partials_kernel adds the
//        partials in block order: no atomics, the same bits every run.  The
//        leaky select reads the saved output here, so the masked cotangent
//        never goes through device memory.  F wider than 64 is split over
//        gridDim.y, 64 features a block.
#include "common.cuh"

namespace {

constexpr int K = 3;
constexpr int KK = 9;
constexpr int NT = 256;
constexpr int TW = 32;            // output tile width (pixels)
constexpr int TH = 8;             // output tile height
constexpr int XW = 2 * TW + 1;    // x halo tile width
constexpr int XH = 2 * TH + 1;
constexpr int PX = 8;             // output pixels of one row per thread (fwd)
constexpr int FC = 64;            // features per block of the dW kernel

// Halo tile of x for the output tile at (oh0, ow0): planes sx[ci][XH][XW],
// padded rows 2*oh0-1 .. 2*oh0+2*TH-1, zero outside the image.
template <typename T, int CIN>
__device__ __forceinline__ void stage_x(float* sx, const T* xn, int oh0,
                                        int ow0, int H, int W, int tid) {
  if constexpr (CIN == 4) {  // one vector load per pixel
    for (int i = tid; i < XH * XW; i += NT) {
      const int r = i / XW;
      const int c = i - r * XW;
      const int gh = 2 * oh0 - 1 + r;
      const int gw = 2 * ow0 - 1 + c;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gh >= 0 && gh < H && gw >= 0 && gw < W)
        load4(xn + ((size_t)gh * W + gw) * 4, v);
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) sx[(ci * XH + r) * XW + c] = v[ci];
    }
    return;
  }
  const int rowlen = XW * CIN;
  for (int i = tid; i < XH * rowlen; i += NT) {
    const int r = i / rowlen;
    const int e = i - r * rowlen;
    const int c = e / CIN;
    const int ci = e - c * CIN;
    const int gh = 2 * oh0 - 1 + r;
    const int gw = 2 * ow0 - 1 + c;
    float v = 0.f;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W)
      v = to_f(xn[((size_t)gh * W + gw) * CIN + ci]);
    sx[(ci * XH + r) * XW + c] = v;
  }
}

// ------------------------------------------------------------------ forward
template <typename T, int CIN, bool LEAKY>
__global__ void __launch_bounds__(NT)
    s2_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y, int H, int W,
                  int F, float slope) {
  extern __shared__ __align__(16) float smem[];
  constexpr int SXP = (CIN * XH * XW + 3) & ~3;  // keeps sw 16-byte aligned
  float* sx = smem;                       // [CIN][XH][XW]
  float* sw = smem + SXP;                 // [9*CIN][F]
  float* sb = sw + KK * CIN * F;          // [F]
  const int HO = H / 2, WO = W / 2;
  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * TH;
  const int ow0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  for (int i = tid; i < KK * CIN * F; i += NT) sw[i] = to_f(w[i]);
  for (int i = tid; i < F; i += NT) sb[i] = b[i];
  stage_x<T, CIN>(sx, x + (size_t)n * H * W * CIN, oh0, ow0, H, W, tid);
  __syncthreads();

  const int FQ = F / 4;
  const int nstrips = TH * (TW / PX);
  for (int it = tid; it < nstrips * FQ; it += NT) {
    const int fq = it % FQ;
    const int strip = it / FQ;
    const int r = strip / (TW / PX);
    const int c0 = (strip % (TW / PX)) * PX;
    float acc[PX][4];
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[p][k] = 0.f;
    // not unrolled over ci: unrolled, the compiler hoists every row's loads
    // (12 x 17 values at cin 4), needs 255 registers and spills
#pragma unroll 1
    for (int ci = 0; ci < CIN; ++ci) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        float xv[2 * PX + 1];
        const float* row = sx + (ci * XH + 2 * r + dy) * XW + 2 * c0;
#pragma unroll
        for (int i = 0; i < 2 * PX + 1; ++i) xv[i] = row[i];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(
              sw + ((dy * K + dx) * CIN + ci) * F + fq * 4);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const float v = xv[2 * p + dx];
            acc[p][0] = fmaf(v, wv.x, acc[p][0]);
            acc[p][1] = fmaf(v, wv.y, acc[p][1]);
            acc[p][2] = fmaf(v, wv.z, acc[p][2]);
            acc[p][3] = fmaf(v, wv.w, acc[p][3]);
          }
        }
      }
    }
    const int oh = oh0 + r;
    if (oh >= HO) continue;
    const float4 bv = *reinterpret_cast<const float4*>(sb + fq * 4);
    const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int ow = ow0 + c0 + p;
      if (ow >= WO) break;
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = acc[p][k] + bb[k];
        if (LEAKY) v = fmaxf(v, slope * v);
        o[k] = v;
      }
      store4(y + (((size_t)n * HO + oh) * WO + ow) * F + fq * 4, o);
    }
  }
}

// ------------------------------------------------------------------ dW + db
template <typename T, int CIN, bool MASK>
__global__ void __launch_bounds__(NT)
    s2_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const T* __restrict__ y, float* __restrict__ part, int H,
                 int W, int F, float slope, int tiles_x, int tiles_y,
                 int ntiles) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                     // [CIN][XH][XW]
  float* sred = smem + CIN * XH * XW;   // [9*CIN + 1][fc]
  const int HO = H / 2, WO = W / 2;
  const int tid = threadIdx.x;
  const int f0 = blockIdx.y * FC;               // this block's features
  const int fc = min(FC, F - f0);
  const int FQ = fc / 4;
  const int ncomb = FQ * CIN;                   // (feature quad, channel)
  const int combo = tid % ncomb;
  const int fq = combo % FQ;
  const int ci = combo / FQ;
  const int lane = tid / ncomb;                 // share of the tile's pixels
  const int nl = NT / ncomb;
  const bool active = lane < nl;
  float acc[KK][4];
  float dbv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < KK; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n = tile / (tiles_x * tiles_y);
    const int rem = tile - n * tiles_x * tiles_y;
    const int oh0 = (rem / tiles_x) * TH;
    const int ow0 = (rem % tiles_x) * TW;
    __syncthreads();
    stage_x<T, CIN>(sx, x + (size_t)n * H * W * CIN, oh0, ow0, H, W, tid);
    __syncthreads();
    if (!active) continue;
    for (int p = lane; p < TH * TW; p += nl) {
      const int r = p / TW;
      const int c = p - r * TW;
      const int oh = oh0 + r;
      const int ow = ow0 + c;
      if (oh >= HO || ow >= WO) continue;
      const size_t off = (((size_t)n * HO + oh) * WO + ow) * F + f0 + fq * 4;
      float gm[4];
      load4(g + off, gm);
      if (MASK) {
        float yv[4];
        load4(y + off, yv);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (!(yv[k] >= 0.f)) gm[k] *= slope;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) dbv[k] += gm[k];
      const float* base = sx + (ci * XH + 2 * r) * XW + 2 * c;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float xv = base[dy * XW + dx];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[dy * K + dx][k] = fmaf(xv, gm[k], acc[dy * K + dx][k]);
        }
    }
  }
  // the block's threads that share (fq, ci), added in lane order
  for (int rnd = 0; rnd < nl; ++rnd) {
    __syncthreads();
    if (active && lane == rnd) {
#pragma unroll
      for (int t = 0; t < KK; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = (t * CIN + ci) * fc + fq * 4 + k;
          sred[i] = (rnd == 0 ? 0.f : sred[i]) + acc[t][k];
        }
      if (ci == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = KK * CIN * fc + fq * 4 + k;
          sred[i] = (rnd == 0 ? 0.f : sred[i]) + dbv[k];
        }
      }
    }
  }
  __syncthreads();
  const int rows = KK * CIN + 1;
  float* mine = part + (size_t)blockIdx.x * rows * F;
  for (int i = tid; i < rows * fc; i += NT) {
    const int row = i / fc;
    const int col = i - row * fc;
    mine[(size_t)row * F + f0 + col] = sred[i];
  }
}

// ----------------------------------------------------------------- launches
template <typename K_>
cudaError_t set_smem(K_ kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int CIN>
cudaError_t fwd_tc(const void* x, const void* w, const void* b, void* y, int n,
                   int h, int wd, int f, int leaky, float slope,
                   cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (CIN * XH * XW + 8 + (KK * CIN + 1) * (size_t)f);
  dim3 grid((wd / 2 + TW - 1) / TW, (h / 2 + TH - 1) / TH, n);
  auto kern = leaky ? s2_fwd_kernel<T, CIN, true> : s2_fwd_kernel<T, CIN, false>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, smem, s>>>(static_cast<const T*>(x),
                              static_cast<const T*>(w),
                              static_cast<const float*>(b), static_cast<T*>(y),
                              h, wd, f, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_t(const void* x, const void* w, const void* b, void* y, int n,
                  int h, int wd, int cin, int f, int leaky, float slope,
                  cudaStream_t s) {
  if (cin == 1) return fwd_tc<T, 1>(x, w, b, y, n, h, wd, f, leaky, slope, s);
  if (cin == 2) return fwd_tc<T, 2>(x, w, b, y, n, h, wd, f, leaky, slope, s);
  if (cin == 4) return fwd_tc<T, 4>(x, w, b, y, n, h, wd, f, leaky, slope, s);
  return cudaErrorInvalidValue;
}

template <typename T, int CIN>
cudaError_t dw_tc(const void* x, const void* g, const void* y, void* part,
                  void* out, int nblocks, int n, int h, int wd, int f, int mask,
                  float slope, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (CIN * XH * XW + (KK * CIN + 1) * (size_t)FC);
  const int tx = (wd / 2 + TW - 1) / TW, ty = (h / 2 + TH - 1) / TH;
  auto kern = mask ? s2_dw_kernel<T, CIN, true> : s2_dw_kernel<T, CIN, false>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(nblocks, (f + FC - 1) / FC);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(y), static_cast<float*>(part), h, wd, f, slope, tx,
      ty, n * tx * ty);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int len = (KK * CIN + 1) * f;
  sum_partials_kernel<<<(len + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nblocks, len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw_t(const void* x, const void* g, const void* y, void* part,
                 void* out, int nblocks, int n, int h, int wd, int cin, int f,
                 int mask, float slope, cudaStream_t s) {
  if (cin == 1)
    return dw_tc<T, 1>(x, g, y, part, out, nblocks, n, h, wd, f, mask, slope, s);
  if (cin == 2)
    return dw_tc<T, 2>(x, g, y, part, out, nblocks, n, h, wd, f, mask, slope, s);
  if (cin == 4)
    return dw_tc<T, 4>(x, g, y, part, out, nblocks, n, h, wd, f, mask, slope, s);
  return cudaErrorInvalidValue;
}

bool bad_shape(int n, int h, int wd, int f) {
  return n <= 0 || n > 65535 || h <= 0 || wd <= 0 || h % 2 != 0 ||
         wd % 2 != 0 || f <= 0 || f % 8 != 0 || f > 512;
}

}  // namespace

DEFINE_ERROR_STRING(conv_s2)

// x (n,h,wd,cin), w (3,3,cin,f), y (n,h/2,wd/2,f) in `dtype`; b (f,) fp32; all
// contiguous; cin 1, 2 or 4; h, wd even.  leaky != 0 applies max(v, slope*v).
// Returns cudaGetLastError() after the launch.
extern "C" int conv_s2_fwd_launch(const void* x, const void* w, const void* b,
                                  void* y, int n, int h, int wd, int cin,
                                  int f, int leaky, float slope, int dtype,
                                  void* stream) {
  if (bad_shape(n, h, wd, f)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return fwd_t<float>(x, w, b, y, n, h, wd, cin, f, leaky, slope, s);
  if (dtype == kBF16)
    return fwd_t<__nv_bfloat16>(x, w, b, y, n, h, wd, cin, f, leaky, slope, s);
  return cudaErrorInvalidValue;
}

// x (n,h,wd,cin), g and y (n,h/2,wd/2,f) in `dtype` (y is read only when
// mask != 0); part: fp32 scratch of nblocks*(9*cin+1)*f; out: fp32
// (9*cin+1, f), rows 0..9*cin-1 dW as (3,3,cin,f), the last row db.
extern "C" int conv_s2_dw_launch(const void* x, const void* g, const void* y,
                                 void* part, void* out, int nblocks, int n,
                                 int h, int wd, int cin, int f, int mask,
                                 float slope, int dtype, void* stream) {
  if (bad_shape(n, h, wd, f) || nblocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dw_t<float>(x, g, y, part, out, nblocks, n, h, wd, cin, f, mask,
                       slope, s);
  if (dtype == kBF16)
    return dw_t<__nv_bfloat16>(x, g, y, part, out, nblocks, n, h, wd, cin, f,
                               mask, slope, s);
  return cudaErrorInvalidValue;
}
