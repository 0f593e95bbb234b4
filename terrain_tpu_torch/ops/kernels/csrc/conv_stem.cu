// conv_stem: 5x5 stride-1 zero-padded convolution of a ONE-channel image
// into F feature maps, with bias and an optional LeakyReLU epilogue, and its
// two gradient kernels.
//
// Replaces the TPU kernels of terrain_tpu/ops/pallas/conv_stem.py:
//   conv_stem_fwd_launch  <- _fwd_kernel via _conv_stem_fwd_pallas
//   conv_stem_dw_launch   <- _dw_kernel  via _conv_stem_dw_pallas (dW + db)
//   conv_stem_dx_launch   <- _dx_kernel  via _conv_stem_dx_pallas
//
//   y[n,h,w,f]  = act(b[f] + sum_{dy,dx} x[n,h+dy-2,w+dx-2] * w[dy,dx,f])
//                 act(v) = max(v, slope*v) when a slope is given
//   gm          = g where the saved y >= 0, else slope*g   (with a slope)
//   dW[dy,dx,f] = sum_{n,h,w} x[n,h+dy-2,w+dx-2] * gm[n,h,w,f]
//   db[f]       = sum_{n,h,w} gm[n,h,w,f]
//   dX[n,h,w]   = sum_{dy,dx,f} gm[n,h+2-dy,w+2-dx,f] * w[dy,dx,f]
//   x (N,H,W,1), g and y (N,H,W,F) in `dtype`; w (5,5,1,F) in `dtype`;
//   b, dW, db fp32.  Products and sums in fp32 whatever the input type.
//
// What bounds them on the card: bytes.  At the DCGAN discriminator's shape
// (N,512,512,1) -> 64 the forward writes 64 values per pixel read (537 MB at
// N=8, about 0.16 ms at 3.35 TB/s, against 0.10 ms of fp32 FMAs); dW reads g
// and y (1.07 GB at N=8) and dX reads them at N=4.  The leaky mask is taken
// from the saved output inside the two gradient kernels, so the masked
// cotangent never makes a round trip through device memory.
//
// Design: the TPU kernels' plane stacks, (8,128) paddings, transposed
// cotangent and VMEM round trips have no counterpart here.  Every kernel
// keeps the F axis on neighbouring threads, 4 values (16 bytes) a thread, so
// that each read of g/y and each write of y is a run of whole 128-byte lines.
//   fwd: a block stages a (8+4)x(32+4) halo tile of x and the 25xF weights in
//        shared memory; a thread owns 8 pixels of a row x 4 features in
//        registers, so a weight load feeds 32 FMAs.
//   dW:  a stream: at its shape it reads 1.07 GB (g and y) for 0.10 ms of
//        FMAs, so the design keeps bytes in flight.  One persistent block
//        per SM walks a fixed share of the tiles (a run of up to 64 pixels
//        of one row x all F features: 16 KB of g and 16 KB of y at F = 64,
//        contiguous in NHWC) in a fixed order.  One thread brings each
//        tile into a ring of 4 stages with two 1-D bulk copies (the TMA
//        unit; completion on one mbarrier a stage), issued three tiles
//        ahead, so ~96 KB per SM are in flight while the threads compute
//        from shared memory; the tile's 5 x rows come three tiles ahead
//        through registers into a double buffer.  One __syncthreads per
//        tile.  A thread keeps 25 taps x 4 features (+ db) in registers
//        over all its pixels, taken in pairs so that one row of 6 x values
//        feeds both.  In trial builds on the card, 16-byte cp.async from
//        every thread streamed slower than the bulk copies, and 2 features
//        a thread on 16 warps or pixels by 3 or 4 were no faster.  The
//        block reduces over its threads in shared memory in a fixed order,
//        writes one partial, and sum_partials_kernel adds the partials in
//        block order: no atomics, the same bits every run.
//   dX:  per halo pixel p the 25 tap values h[p][t] = sum_f gm[p,f]*w[t,f]
//        are computed once (4 threads split F, two shuffles reduce) into
//        shared memory, then each output pixel gathers its 25 shifted taps.
#include "common.cuh"

namespace {

constexpr int K = 5;
constexpr int KK = 25;
constexpr int NT = 256;           // threads per block, all three kernels
constexpr int TW = 32;            // tile width (pixels)
constexpr int TH = 8;             // tile height, fwd
constexpr int XW = TW + 4;        // x halo tile width
constexpr int XH = TH + 4;
constexpr int PX = 8;             // pixels of one row per thread (fwd)
constexpr int DTH = 16;           // tile height, dX
constexpr int HW_ = TW + 4;       // dX halo tile width
constexpr int HH_ = DTH + 4;
constexpr int HP = HW_ * HH_;     // dX halo pixels per tile

template <typename T>
__device__ __forceinline__ void stage_x(float* sx, const T* xn, int h0, int w0,
                                        int H, int W, int tid) {
  for (int i = tid; i < XH * XW; i += NT) {
    const int r = i / XW;
    const int c = i - r * XW;
    const int gh = h0 - 2 + r;
    const int gw = w0 - 2 + c;
    float v = 0.f;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W)
      v = to_f(xn[(size_t)gh * W + gw]);
    sx[i] = v;
  }
}

// ------------------------------------------------------------------ forward
template <typename T, bool LEAKY>
__global__ void __launch_bounds__(NT)
    stem_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b, T* __restrict__ y, int H,
                    int W, int F, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                 // [XH][XW]
  float* sw = smem + XH * XW;       // [25][F]
  float* sb = sw + KK * F;          // [F]
  const int n = blockIdx.z;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  for (int i = tid; i < KK * F; i += NT) sw[i] = to_f(w[i]);
  for (int i = tid; i < F; i += NT) sb[i] = b[i];
  stage_x(sx, x + (size_t)n * H * W, h0, w0, H, W, tid);
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
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      float xv[PX + 4];
#pragma unroll
      for (int i = 0; i < PX + 4; ++i) xv[i] = sx[(r + dy) * XW + c0 + i];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float4 wv = *reinterpret_cast<const float4*>(
            sw + (dy * K + dx) * F + fq * 4);
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          acc[p][0] = fmaf(xv[p + dx], wv.x, acc[p][0]);
          acc[p][1] = fmaf(xv[p + dx], wv.y, acc[p][1]);
          acc[p][2] = fmaf(xv[p + dx], wv.z, acc[p][2]);
          acc[p][3] = fmaf(xv[p + dx], wv.w, acc[p][3]);
        }
      }
    }
    const int gh = h0 + r;
    if (gh >= H) continue;
    const float4 bv = *reinterpret_cast<const float4*>(sb + fq * 4);
    const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int gw = w0 + c0 + p;
      if (gw >= W) break;
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = acc[p][k] + bb[k];
        if (LEAKY) v = fmaxf(v, slope * v);
        o[k] = v;
      }
      store4(y + (((size_t)n * H + gh) * W + gw) * F + fq * 4, o);
    }
  }
}

// --------------------------------------------------------------- masked g
template <typename T, bool MASK>
__device__ __forceinline__ void load_gm(const T* g, const T* y, size_t off,
                                        float slope, float gm[4]) {
  load4(g + off, gm);
  if (MASK) {
    float yv[4];
    load4(y + off, yv);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (!(yv[k] >= 0.f)) gm[k] *= slope;
  }
}

// ------------------------------------------------------------------ dW + db
constexpr int DW_STAGES = 4;      // ring of tiles in shared memory
constexpr int DW_ELEMS = 4096;    // elements of g (and of y) per stage
constexpr int DW_TPMAX = 128;     // most pixels per tile
constexpr int DW_XW = DW_TPMAX + 5;  // x row: taps of TP pixels + 1 spare
constexpr int DW_XPT = (K * DW_XW + NT - 1) / NT;  // x values per thread

// pixels per tile: a stage holds DW_ELEMS values of g
__host__ __device__ inline int dw_tile_px(int f) {
  return f * DW_TPMAX <= DW_ELEMS ? DW_TPMAX : DW_ELEMS / f;
}

template <typename T>
constexpr size_t dw_smem_bytes() {
  return 2 * DW_STAGES * DW_ELEMS * sizeof(T) +
         2 * K * DW_XW * sizeof(float) + DW_STAGES * sizeof(uint64_t);
}

// A load the compiler keeps where it is written: the x rows are loaded
// tiles ahead of their use, and a plain load of read-only data may be moved
// down to it (in a trial build on the card that was slower).
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

template <typename T, bool MASK>
__global__ void __launch_bounds__(NT)
    stem_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const T* __restrict__ y, float* __restrict__ part, int H,
                   int W, int F, float slope, int tiles_w, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sg = reinterpret_cast<T*>(smem_raw);     // [DW_STAGES][DW_ELEMS]
  T* sy = sg + DW_STAGES * DW_ELEMS;          // the same, for y (MASK)
  float* sx = reinterpret_cast<float*>(sy + DW_STAGES * DW_ELEMS);
                                              // [2][K][DW_XW]
  uint64_t* full = reinterpret_cast<uint64_t*>(sx + 2 * K * DW_XW);
                                              // [DW_STAGES]: tile landed
  float* sred = reinterpret_cast<float*>(smem_raw);  // [26][F], at the end
  const int tid = threadIdx.x;
  const int FQ = F / 4;
  const int fq = tid % FQ;
  const int lane = tid / FQ;        // which share of the tile's pixels
  const int nl = NT / FQ;
  const bool active = lane < nl;
  const int TP = dw_tile_px(F);
  // the last pixel of an odd run reads one column past its taps (times 0)
  const int XW = TP + 5;
  // this block's tiles: blockIdx.x + k * gridDim.x for k < nmine
  const int nmine = (int)blockIdx.x < ntiles
                        ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;

  auto locate = [&](int k, int& n, int& h, int& w0) {
    const int t = blockIdx.x + k * gridDim.x;
    const int r = t / tiles_w;
    w0 = (t - r * tiles_w) * TP;
    h = r % H;
    n = r / H;
  };
  // thread 0 copies tile k into stage k % DW_STAGES: g (and y) of the
  // tile's pixels are one contiguous run each
  auto issue = [&](int k) {
    if (tid != 0 || k >= nmine) return;
    int n, h, w0;
    locate(k, n, h, w0);
    const size_t off = (((size_t)n * H + h) * W + w0) * F;
    const uint32_t bytes = min(TP, W - w0) * F * sizeof(T);
    uint64_t* bar = full + k % DW_STAGES;
    fence_proxy_async();  // after the block's reads of this stage
    mbar_expect_tx(bar, (MASK ? 2 : 1) * bytes);
    bulk_copy(sg + (k % DW_STAGES) * DW_ELEMS, g + off, bytes, bar);
    if (MASK) bulk_copy(sy + (k % DW_STAGES) * DW_ELEMS, y + off, bytes, bar);
  };
  // x rows h-2..h+2, columns w0-2..w0+TP+2 of tile k (zeros outside the
  // image) into registers, and from there into sx[k % 2]
  auto load_x = [&](int k, float (&xr)[DW_XPT]) {
    if (k >= nmine) return;
    int n, h, w0;
    locate(k, n, h, w0);
    const T* xn = x + (size_t)n * H * W;
#pragma unroll
    for (int j = 0; j < DW_XPT; ++j) {
      const int i = tid + j * NT;
      const int r = i / XW;
      const int gh = h - 2 + r;
      const int gw = w0 - 2 + i - r * XW;
      float v = 0.f;
      if (i < K * XW && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = load_early(xn + (size_t)gh * W + gw);
      xr[j] = v;
    }
  };
  auto store_x = [&](int k, const float (&xr)[DW_XPT]) {
    if (k >= nmine) return;
    float* d = sx + (k & 1) * K * DW_XW;
#pragma unroll
    for (int j = 0; j < DW_XPT; ++j) {
      const int i = tid + j * NT;
      if (i < K * XW) d[i] = xr[j];
    }
  };

  float acc[KK][4];
  float dbv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < KK; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;

  auto compute = [&](int k) {
    if (!active) return;
    int n, h, w0;
    locate(k, n, h, w0);
    const int np = min(TP, W - w0);
    const T* tg = sg + (k % DW_STAGES) * DW_ELEMS + fq * 4;
    const T* ty = sy + (k % DW_STAGES) * DW_ELEMS + fq * 4;
    const float* tx = sx + (k & 1) * K * DW_XW;
    // pixels in pairs: one row of 6 x values serves both
    for (int p = 2 * lane; p < np; p += 2 * nl) {
      const bool two = p + 1 < np;
      float gm0[4], gm1[4] = {0.f, 0.f, 0.f, 0.f};
      load4(tg + p * F, gm0);
      if (two) load4(tg + (p + 1) * F, gm1);
      if (MASK) {
        float y0[4], y1[4] = {0.f, 0.f, 0.f, 0.f};
        load4(ty + p * F, y0);
        if (two) load4(ty + (p + 1) * F, y1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!(y0[c] >= 0.f)) gm0[c] *= slope;
          if (!(y1[c] >= 0.f)) gm1[c] *= slope;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) dbv[c] += gm0[c] + gm1[c];
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        float xv[K + 1];
#pragma unroll
        for (int i = 0; i < K + 1; ++i) xv[i] = tx[dy * XW + p + i];
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[dy * K + dx][c] = fmaf(xv[dx + 1], gm1[c],
                                       fmaf(xv[dx], gm0[c],
                                            acc[dy * K + dx][c]));
      }
    }
  };

  // one tile: its x rows come from registers loaded two tiles earlier
  auto step = [&](int k, float (&xr)[DW_XPT]) {
    mbar_wait(full + k % DW_STAGES, (k / DW_STAGES) & 1);
    // tile k and its x rows are in; every thread is done with tile k-1,
    // whose stage and x buffer are refilled next
    __syncthreads();
    issue(k + DW_STAGES - 1);
    store_x(k + 1, xr);
    load_x(k + 3, xr);
    compute(k);
  };
  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  float xa[DW_XPT], xb[DW_XPT];
  for (int s = 0; s < DW_STAGES - 1; ++s) issue(s);
  load_x(0, xa);
  store_x(0, xa);
  load_x(1, xa);
  load_x(2, xb);
  for (int k = 0; k < nmine; k += 2) {  // two register sets, in turn
    step(k, xa);
    if (k + 1 < nmine) step(k + 1, xb);
  }
  // the block's threads that share fq, added in lane order
  for (int rnd = 0; rnd < nl; ++rnd) {
    __syncthreads();
    if (active && lane == rnd) {
#pragma unroll
      for (int t = 0; t <= KK; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = t * F + fq * 4 + c;
          const float v = t < KK ? acc[t < KK ? t : 0][c] : dbv[c];
          sred[i] = (rnd == 0 ? 0.f : sred[i]) + v;
        }
    }
  }
  __syncthreads();
  const int len = (KK + 1) * F;
  for (int i = tid; i < len; i += NT)
    part[(size_t)blockIdx.x * len + i] = sred[i];
}

// ----------------------------------------------------------------------- dX
template <typename T, bool MASK>
__global__ void __launch_bounds__(NT)
    stem_dx_kernel(const T* __restrict__ g, const T* __restrict__ y,
                   const T* __restrict__ w, T* __restrict__ dxo, int H, int W,
                   int F, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* sh = smem;                 // [25][HP] tap values of the halo pixels
  float* sw = smem + KK * HP;       // [25][F]
  const int n = blockIdx.z;
  const int h0 = blockIdx.y * DTH;
  const int w0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int FQ = F / 4;
  for (int i = tid; i < KK * F; i += NT) sw[i] = to_f(w[i]);
  __syncthreads();

  const int quad = tid >> 2;        // 64 pixels in flight
  const int l = tid & 3;            // this thread's share of F
  for (int base = 0; base < HP; base += NT / 4) {
    const int p = base + quad;
    const int hr = p / HW_;
    const int hc = p - hr * HW_;
    const int gh = h0 - 2 + hr;
    const int gw = w0 - 2 + hc;
    const bool inimg = p < HP && gh >= 0 && gh < H && gw >= 0 && gw < W;
    float acc[KK];
#pragma unroll
    for (int t = 0; t < KK; ++t) acc[t] = 0.f;
    if (inimg) {
      const size_t off = (((size_t)n * H + gh) * W + gw) * F;
      for (int q = l; q < FQ; q += 4) {
        float gm[4];
        load_gm<T, MASK>(g, y, off + q * 4, slope, gm);
#pragma unroll
        for (int t = 0; t < KK; ++t) {
          const float4 wv =
              *reinterpret_cast<const float4*>(sw + t * F + q * 4);
          acc[t] = fmaf(gm[0], wv.x, acc[t]);
          acc[t] = fmaf(gm[1], wv.y, acc[t]);
          acc[t] = fmaf(gm[2], wv.z, acc[t]);
          acc[t] = fmaf(gm[3], wv.w, acc[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < KK; ++t) {
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 1);
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 2);
    }
    if (p < HP) {
#pragma unroll
      for (int t = 0; t < KK; ++t)
        if ((t & 3) == l) sh[t * HP + p] = acc[t];
    }
  }
  __syncthreads();

  for (int o = tid; o < DTH * TW; o += NT) {
    const int r = o / TW;
    const int c = o - r * TW;
    const int gh = h0 + r;
    const int gw = w0 + c;
    if (gh >= H || gw >= W) continue;
    float s = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        s += sh[(dy * K + dx) * HP + (r + 4 - dy) * HW_ + (c + 4 - dx)];
    dxo[((size_t)n * H + gh) * W + gw] = from_f<T>(s);
  }
}

// ----------------------------------------------------------------- launches
template <typename K_>
cudaError_t set_smem(K_ kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t fwd_t(const void* x, const void* w, const void* b, void* y, int n,
                  int h, int wd, int f, int leaky, float slope,
                  cudaStream_t s) {
  const size_t smem = sizeof(float) * (XH * XW + (KK + 1) * (size_t)f);
  dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, n);
  auto kern = leaky ? stem_fwd_kernel<T, true> : stem_fwd_kernel<T, false>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, smem, s>>>(static_cast<const T*>(x),
                              static_cast<const T*>(w),
                              static_cast<const float*>(b),
                              static_cast<T*>(y), h, wd, f, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw_t(const void* x, const void* g, const void* y, void* part,
                 void* out, int nblocks, int n, int h, int wd, int f,
                 int mask, float slope, cudaStream_t s) {
  const size_t smem = dw_smem_bytes<T>();  // also holds the (26,f) sums
  const int tiles_w = (wd + dw_tile_px(f) - 1) / dw_tile_px(f);
  const long long ntiles = (long long)n * h * tiles_w;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  auto kern = mask ? stem_dw_kernel<T, true> : stem_dw_kernel<T, false>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<nblocks, NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(y), static_cast<float*>(part), h, wd, f, slope,
      tiles_w, (int)ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int len = (KK + 1) * f;
  sum_partials_kernel<<<(len + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nblocks,
      len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dx_t(const void* g, const void* y, const void* w, void* dx, int n,
                 int h, int wd, int f, int mask, float slope,
                 cudaStream_t s) {
  const size_t smem = sizeof(float) * (KK * HP + KK * (size_t)f);
  dim3 grid((wd + TW - 1) / TW, (h + DTH - 1) / DTH, n);
  auto kern = mask ? stem_dx_kernel<T, true> : stem_dx_kernel<T, false>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, smem, s>>>(static_cast<const T*>(g),
                              static_cast<const T*>(y),
                              static_cast<const T*>(w), static_cast<T*>(dx), h,
                              wd, f, slope);
  return cudaGetLastError();
}

bool bad_shape(int n, int h, int wd, int f) {
  return n <= 0 || n > 65535 || h <= 0 || wd <= 0 || f <= 0 || f % 8 != 0 ||
         f > 512;
}

}  // namespace

DEFINE_ERROR_STRING(conv_stem)

// x (n,h,wd,1), w (5,5,1,f), y (n,h,wd,f) in `dtype`; b (f,) fp32; all
// contiguous.  leaky != 0 applies max(v, slope*v).  Returns
// cudaGetLastError() after the launch.
extern "C" int conv_stem_fwd_launch(const void* x, const void* w,
                                    const void* b, void* y, int n, int h,
                                    int wd, int f, int leaky, float slope,
                                    int dtype, void* stream) {
  if (bad_shape(n, h, wd, f)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return fwd_t<float>(x, w, b, y, n, h, wd, f, leaky, slope, s);
  if (dtype == kBF16)
    return fwd_t<__nv_bfloat16>(x, w, b, y, n, h, wd, f, leaky, slope, s);
  return cudaErrorInvalidValue;
}

// x (n,h,wd,1), g and y (n,h,wd,f) in `dtype` (y is read only when mask != 0),
// g and y 16-byte aligned; part: fp32 scratch of nblocks*26*f (one block
// per SM is the design: each takes ~134 KB of shared memory); out: fp32
// (26,f), rows 0..24 dW as (5,5,1,f), row 25 db.
extern "C" int conv_stem_dw_launch(const void* x, const void* g,
                                   const void* y, void* part, void* out,
                                   int nblocks, int n, int h, int wd, int f,
                                   int mask, float slope, int dtype,
                                   void* stream) {
  if (bad_shape(n, h, wd, f) || nblocks <= 0 ||
      (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(y)) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dw_t<float>(x, g, y, part, out, nblocks, n, h, wd, f, mask, slope, s);
  if (dtype == kBF16)
    return dw_t<__nv_bfloat16>(x, g, y, part, out, nblocks, n, h, wd, f, mask,
                               slope, s);
  return cudaErrorInvalidValue;
}

// g and y (n,h,wd,f), w (5,5,1,f), dx (n,h,wd,1), all in `dtype`.
extern "C" int conv_stem_dx_launch(const void* g, const void* y,
                                   const void* w, void* dx, int n, int h,
                                   int wd, int f, int mask, float slope,
                                   int dtype, void* stream) {
  if (bad_shape(n, h, wd, f)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dx_t<float>(g, y, w, dx, n, h, wd, f, mask, slope, s);
  if (dtype == kBF16)
    return dx_t<__nv_bfloat16>(g, y, w, dx, n, h, wd, f, mask, slope, s);
  return cudaErrorInvalidValue;
}
