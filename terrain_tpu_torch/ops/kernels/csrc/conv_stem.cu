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
// cotangent and VMEM round trips have no counterpart here.  The F axis is
// contiguous in NHWC, so every kernel moves whole runs of pixels x F, and
// one block per SM (or as many as fit, for the forward) walks a fixed share
// of the work in a fixed order, so nothing is summed across blocks by
// atomics and every run gives the same bits.
//   fwd: bound by writing y; its 3.4 G fp32 FMAs at batch 8 (0.10 ms on the
//        CUDA cores) are done on the TF32 tensor cores, as the TPU kernel
//        does its 25-deep contraction as one MXU dot: per tile (64 pixels of
//        a row x all F, fewer pixels when F > 64) C (pixels x F) = patches
//        (pixels x 32 taps, 25 used) x W (32 x F), mma.sync.m16n8k8.  fp32
//        takes the 3xTF32 split of bilinear_conv.cu (x and w hi + lo, lo*hi
//        + hi*lo + hi*hi); bf16 x and w are exact in TF32, one pass.  The
//        weights are split once into two planes (taps contiguous, padded for
//        ldmatrix); a warp builds its 16 pixels' patch fragments from the
//        tile's x halo (5 rows x TP+4, loaded a tile ahead through
//        registers).  Bias and activation go onto the accumulators, the
//        tile into a padded buffer in shared memory (two, in turn), and all
//        threads then write it to y as 16-byte stores of one contiguous run.
//        One __syncthreads per tile.  (A version on the CUDA cores, 8 x 4
//        outputs a thread, staged tiles written by one-thread bulk stores,
//        measured no faster in fp32 and slower in bf16: PERF.md.)
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
//   dX:  bound by reading g and y, each byte once.  With the 25 tap values
//        h[p][t] = sum_f gm[p,f] * w[t,f] of every pixel p,
//        dX[r,c] = sum_{dy,dx} h[(r+2-dy, c+2-dx)][dy*5+dx].  The image is
//        cut into column strips of SW = SWP-4 outputs (SWP = 64 pixels at
//        F <= 64; F > 64 narrows them, SWP*F <= 4096), and each block walks
//        its share of the (image, strip, row) order down the strips, row by
//        row, so no h-row is computed twice except the 4 halo rows where a
//        share starts a strip.  A row of the strip (SWP pixels x F of g and
//        of y, two bulk copies) comes through a ring of 4 stages, 4 rows
//        ahead (up to 128 KB in flight at F = 64, fp32).  The warps have two
//        roles, a row apart: 5 copy warps mask the next row's g into a
//        padded plane (two, in turn) and sum the output row the last h-row
//        completed, while 5 tap warps compute this row's tap values into a
//        ring of 6 h-rows from the other plane: a warp takes 2 x 32 pixels
//        x the 5 taps of one kernel row, so its weight loads are warp-
//        uniform (broadcast) and a float4 of weights feeds 8 FMAs.  One
//        __syncthreads a row.  (On the tensor cores, as the forward, the
//        tap values measured slower: PERF.md.)
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int K = 5;
constexpr int KK = 25;
constexpr int NT = 256;           // threads per block, fwd and dW

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


// ------------------------------------------------------------------ forward
constexpr int FW_TPMAX = 64;      // pixels of a tile at F <= 64
constexpr int FW_WS = 36;         // a weight plane row: 32 taps + 4 pad
constexpr int FW_NJ = 8;          // most n-tiles (8 features) of a warp
constexpr int FW_XPT = (K * (FW_TPMAX + 4) + NT - 1) / NT;  // x values/thread

// pixels of a tile: 64, or fewer so that the tile keeps 4096 values
__host__ __device__ inline int fw_tile_px(int f) {
  return f <= 64 ? FW_TPMAX : 4096 / f;
}

template <typename T>
constexpr bool fw_split = std::is_same<T, float>::value;

template <typename T>
size_t fw_smem_bytes(int f) {
  const size_t tp = fw_tile_px(f);
  return sizeof(float) * ((fw_split<T> ? 2 : 1) * (size_t)f * FW_WS + f +
                          2 * K * (tp + 4) + 2 * tp * (f + 4));
}

template <typename T, bool LEAKY>
__global__ void __launch_bounds__(NT)
    stem_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b, T* __restrict__ y, int H,
                    int W, int F, float slope, int tiles_w, int ntiles) {
  constexpr bool kSplit = fw_split<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* whi = reinterpret_cast<float*>(smem_raw);   // [F][FW_WS]: w[tap][f]
  float* wlo = whi + (kSplit ? F * FW_WS : 0);       // fp32 only
  float* sb = wlo + F * FW_WS;                       // [F]
  float* sx = sb + F;                                // [2][K][XW]
  const int TP = fw_tile_px(F);
  const int XW = TP + 4;
  float* so = sx + 2 * K * XW;                       // [2][TP][F+4]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;           // mma fragment indices
  const int FQ = F / 4;
  // warps: MT m-tiles of 16 pixels x NG groups of the F/8 n-tiles
  const int MT = (TP + 15) / 16;
  const int NG = 8 / MT;
  const int mt = (tid >> 5) % MT;
  const int ng = (tid >> 5) / MT;
  // this block's tiles: blockIdx.x + k * gridDim.x for k < nmine
  const int nmine = (int)blockIdx.x < ntiles
                        ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;
  for (int i = tid; i < F * FW_WS; i += NT) {
    const int f = i / FW_WS;
    const int t = i - f * FW_WS;
    const float v = t < KK ? to_f(w[t * F + f]) : 0.f;
    const float hi = kSplit ? tf32_rna(v) : v;
    whi[i] = hi;
    if (kSplit) wlo[i] = tf32_rna(v - hi);
  }
  for (int i = tid; i < F; i += NT) sb[i] = b[i];
  // the x offsets (in the halo tile) of this thread's 8 taps of the A
  // fragments: tap kk*8 + tq (+4); -1 past the 25th
  int toff[4][2];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = kk * 8 + tq + 4 * h;
      toff[kk][h] = t < KK ? (t / K) * XW + t % K : -1;
    }
  // this thread's x halo values: element i = tid + j * NT of K x XW
  int xro[FW_XPT], xco[FW_XPT];
#pragma unroll
  for (int j = 0; j < FW_XPT; ++j) {
    const int i = tid + j * NT;
    xro[j] = i / XW;
    xco[j] = i - xro[j] * XW;
  }

  auto locate = [&](int k, int& n, int& h, int& w0) {
    const int t = blockIdx.x + k * gridDim.x;
    const int r = t / tiles_w;
    w0 = (t - r * tiles_w) * TP;
    h = r % H;
    n = r / H;
  };
  // x rows h-2..h+2, columns w0-2..w0+TP+1 of tile k (zeros outside the
  // image) into registers, and from there into sx[k % 2]
  auto load_x = [&](int k, float (&xr)[FW_XPT]) {
    if (k >= nmine) return;
    int n, h, w0;
    locate(k, n, h, w0);
    const T* xn = x + (size_t)n * H * W;
#pragma unroll
    for (int j = 0; j < FW_XPT; ++j) {
      const int gh = h - 2 + xro[j];
      const int gw = w0 - 2 + xco[j];
      float v = 0.f;
      if (xro[j] < K && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = load_early(xn + (size_t)gh * W + gw);
      xr[j] = v;
    }
  };
  auto store_x = [&](int k, const float (&xr)[FW_XPT]) {
    if (k >= nmine) return;
    float* d = sx + (k & 1) * K * XW;
#pragma unroll
    for (int j = 0; j < FW_XPT; ++j)
      if (xro[j] < K) d[tid + j * NT] = xr[j];
  };

  float xr[FW_XPT];
  load_x(0, xr);
  store_x(0, xr);
  load_x(1, xr);
  __syncthreads();
  for (int k = 0; k < nmine; ++k) {
    int n, h, w0;
    locate(k, n, h, w0);
    const int np = min(TP, W - w0);
    float* st = so + (k & 1) * TP * (F + 4);
    if (ng < NG) {
      // A: the patches of pixels mt*16 + gq (+8), taps as toff, hi and lo
      const float* tx = sx + (k & 1) * K * XW;
      const int pa = mt * 16 + gq;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = pa + 8 * (r & 1);
          const int o = toff[kk][r >> 1];
          const float v = (o >= 0 && p < TP) ? tx[o + p] : 0.f;
          const float hi = kSplit ? tf32_rna(v) : v;
          ahi[kk][r] = __float_as_uint(hi);
          alo[kk][r] = __float_as_uint(kSplit ? tf32_rna(v - hi) : 0.f);
        }
      const int nt = F / 8;
#pragma unroll
      for (int jj = 0; jj < FW_NJ; ++jj) {
        const int j = ng + jj * NG;
        if (j >= nt) break;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        // B rows: features j*8 + lane%8, taps kk*8 + 4*(lane/8 % 2)
        const int brow = (j * 8 + (lane & 7)) * FW_WS + 4 * ((lane >> 3) & 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t bh[2];
          ldsm_x2(bh, whi + brow + kk * 8);
          if (kSplit) {
            uint32_t bl[2];
            ldsm_x2(bl, wlo + brow + kk * 8);
            mma_tf32(acc, alo[kk], bh);
            mma_tf32(acc, ahi[kk], bl);
          }
          mma_tf32(acc, ahi[kk], bh);
        }
        // bias, activation, into the padded tile: rows pa and pa+8,
        // features j*8 + 2*tq, +1
        const int f0 = j * 8 + 2 * tq;
        const float b0 = sb[f0], b1 = sb[f0 + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = pa + 8 * r;
          float v0 = acc[2 * r] + b0, v1 = acc[2 * r + 1] + b1;
          if (LEAKY) {
            v0 = fmaxf(v0, slope * v0);
            v1 = fmaxf(v1, slope * v1);
          }
          if (p < TP)
            *reinterpret_cast<float2*>(st + p * (F + 4) + f0) =
                make_float2(v0, v1);
        }
      }
    }
    store_x(k + 1, xr);  // loaded a tile ago
    load_x(k + 2, xr);
    __syncthreads();     // the tile is in st; tile k+1's x is in sx
    // the tile's np x F outputs, a contiguous run of y, 16 bytes of fp32
    // (8 of bf16) a thread and step
    T* yt = y + (((size_t)n * H + h) * W + w0) * F;
    const int step_p = NT / FQ, step_q = NT % FQ;
    for (int i = tid, p = tid / FQ, q = tid % FQ; i < np * FQ; i += NT) {
      float v[4];
      load4(st + p * (F + 4) + q * 4, v);
      store4(yt + (size_t)i * 4, v);
      p += step_p;  // i = p * FQ + q, without a division
      q += step_q;
      if (q >= FQ) {
        q -= FQ;
        ++p;
      }
    }
  }
}

// ----------------------------------------------------------------------- dX
constexpr int DX_NT = 320;        // 10 warps: 5 tap warps, 5 copy warps
constexpr int DX_TAP_NT = 160;    // warps 0-4: the taps of kernel row 0-4
constexpr int DX_STAGES = 4;      // ring of g (and y) rows
constexpr int DX_ELEMS = 4096;    // elements of g (and of y) per stage
constexpr int DX_SWP = 64;        // most pixels of a strip row, halo included
constexpr int DX_RING = 6;        // h-rows: 5 read while 1 is written

// pixels of a strip row: SWP x F fits a stage
__host__ __device__ inline int dx_swp(int f) {
  return DX_ELEMS / f < DX_SWP ? DX_ELEMS / f : DX_SWP;
}

template <typename T>
size_t dx_smem_bytes(int f) {
  const size_t swp = dx_swp(f);
  return 2 * DX_STAGES * DX_ELEMS * sizeof(T) +
         sizeof(float) *
             (2 * swp * (f + 4) + KK * (size_t)f + DX_RING * KK * swp) +
         DX_STAGES * sizeof(uint64_t);
}

// A block's share of the output rows, in (image, strip, row) order, cut into
// segments at strip ends.  A segment of output rows [r0, r1) takes the
// r1-r0+4 input rows r0-2..r1+1 ("slots" j = 0..), since an output row reads
// the h-rows two above and two below it.
struct DxCursor {
  long long lin, end;  // next output row of the share, end of the share
  int ns, r0, r1, j;   // image*strips + strip, rows of the segment, slot
  __device__ void segment(int H) {
    ns = (int)(lin / H);
    r0 = (int)(lin - (long long)ns * H);
    r1 = (int)min((long long)H, r0 + (end - lin));
    j = 0;
  }
  __device__ void init(long long a, long long e, int H) {
    lin = a;
    end = e;
    if (lin < end) segment(H);
  }
  __device__ bool done() const { return lin >= end; }
  __device__ void next(int H) {
    if (++j == r1 - r0 + 4) {
      lin += r1 - r0;
      if (lin < end) segment(H);
    }
  }
};

// The block's slots go through three steps, a slot apart, in the warps'
// two roles: copy warps convert slot k+1 (its g, masked, into a plane)
// while the tap warps compute the h-row of slot k from the other plane, and
// the copy warps then sum the output row that slot k-1 completed.
template <typename T, bool MASK>
__global__ void __launch_bounds__(DX_NT)
    stem_dx_kernel(const T* __restrict__ g, const T* __restrict__ y,
                   const T* __restrict__ w, T* __restrict__ dxo, int H, int W,
                   int F, float slope, int strips, long long rows,
                   int share) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int swp = dx_swp(F);
  const int sw = swp - 4;           // output columns of a strip
  const int FQ = F / 4;
  const int PS = swp * (F + 4);     // floats of a plane
  T* sg = reinterpret_cast<T*>(smem_raw);     // [DX_STAGES][DX_ELEMS]
  T* sy = sg + DX_STAGES * DX_ELEMS;          // the same, for y (MASK)
  float* plane = reinterpret_cast<float*>(sy + DX_STAGES * DX_ELEMS);
                                              // [2][swp][F+4]: gm of a row
  float* swt = plane + 2 * PS;                // [25][F]
  float* hr = swt + KK * F;                   // [DX_RING][25][swp]
  uint64_t* full = reinterpret_cast<uint64_t*>(hr + DX_RING * KK * swp);
  const int tid = threadIdx.x;
  const bool tapper = tid < DX_TAP_NT;
  const int ct = tid - DX_TAP_NT;   // rank among the copy warps' threads
  const long long a = (long long)blockIdx.x * share;
  if (a >= rows) return;
  const long long e = min(a + share, rows);
  for (int i = tid; i < KK * F; i += DX_NT) swt[i] = to_f(w[i]);

  // the issuing thread copies the g (and y) row of slot c into stage
  // k % DX_STAGES; a row outside the image completes its stage with no bytes
  auto issue = [&](const DxCursor& c, int k) {
    const int n = c.ns / strips;
    const int cb = (c.ns - n * strips) * sw - 2;  // image column of pixel 0
    const int gh = c.r0 - 2 + c.j;
    uint64_t* bar = full + k % DX_STAGES;
    fence_proxy_async();  // after the block's reads of this stage
    if (gh < 0 || gh >= H) {
      mbar_expect_tx(bar, 0);
      return;
    }
    const int lo = max(cb, 0);
    const int hi = min(cb + swp, W);
    const uint32_t bytes = (hi - lo) * F * sizeof(T);
    const size_t off = (((size_t)n * H + gh) * W + lo) * F;
    const int so = (k % DX_STAGES) * DX_ELEMS + (lo - cb) * F;
    mbar_expect_tx(bar, (MASK ? 2 : 1) * bytes);
    bulk_copy(sg + so, g + off, bytes, bar);
    if (MASK) bulk_copy(sy + so, y + off, bytes, bar);
  };
  // copy warps: masked g of slot c (stage k), fp32, into plane k % 2, zeros
  // off the image
  auto convert = [&](const DxCursor& c, int k) {
    mbar_wait(full + k % DX_STAGES, (k / DX_STAGES) & 1);
    const int n = c.ns / strips;
    const int cb = (c.ns - n * strips) * sw - 2;
    const int gh = c.r0 - 2 + c.j;
    const bool in_row = gh >= 0 && gh < H;
    const T* tg = sg + (k % DX_STAGES) * DX_ELEMS;
    const T* ty = sy + (k % DX_STAGES) * DX_ELEMS;
    float* pl = plane + (k & 1) * PS;
    // item i = p * FQ + q, stepped without a division
    const int step_p = (DX_NT - DX_TAP_NT) / FQ;
    const int step_q = (DX_NT - DX_TAP_NT) % FQ;
    int p = ct / FQ, q = ct % FQ;
    for (; p < swp;) {
      const int col = cb + p;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (in_row && col >= 0 && col < W) {
        load4(tg + p * F + q * 4, v);
        if (MASK) {
          float yv[4];
          load4(ty + p * F + q * 4, yv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!(yv[i] >= 0.f)) v[i] *= slope;
        }
      }
      store4(pl + p * (F + 4) + q * 4, v);
      p += step_p;
      q += step_q;
      if (q >= FQ) {
        q -= FQ;
        ++p;
      }
    }
  };
  // copy warps: output row j-4 of slot c's segment, from the h-rows of
  // slots k-4..k
  auto gather = [&](const DxCursor& c, int k) {
    if (c.j < 4 || ct >= sw) return;
    const int n = c.ns / strips;
    const int col = (c.ns - n * strips) * sw + ct;
    if (col >= W) return;
    float s = 0.f;
#pragma unroll
    for (int ty = 0; ty < K; ++ty) {
      const float* h =
          hr + ((k - ty) % DX_RING) * KK * swp + ty * K * swp + ct + 4;
#pragma unroll
      for (int tx = 0; tx < K; ++tx) s += h[tx * swp - tx];
    }
    dxo[((size_t)n * H + c.r0 + c.j - 4) * W + col] = from_f<T>(s);
  };

  if (tid == 0) {
    for (int s = 0; s < DX_STAGES; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // cursors: the slot the taps take (k), the next (k+1, converted), the
  // one before (k-1, summed); the issuing thread's runs DX_STAGES ahead
  DxCursor cur, nxt, prv, pc;
  cur.init(a, e, H);
  nxt = cur;
  const bool issuer = tid == DX_TAP_NT;
  int kp = 0;
  if (issuer) {
    pc = cur;
    for (; kp < DX_STAGES && !pc.done(); ++kp, pc.next(H)) issue(pc, kp);
  }
  if (!tapper) convert(nxt, 0);
  nxt.next(H);
  __syncthreads();
  if (issuer && !pc.done()) {
    issue(pc, kp++);
    pc.next(H);
  }
  const int dy = tid >> 5;            // a tap warp's kernel row
  const int lane = tid & 31;          // its pixels lane and lane + 32
  int k = 0;
  for (; !cur.done(); ++k) {
    if (tapper) {
      // h[t][p] = sum_f gm[p,f] w[t,f], t = dy*5 + dx, two pixels a thread
      const float* pl = plane + (k & 1) * PS;
      const bool two = lane + 32 < swp;
      const float4* p0 = reinterpret_cast<const float4*>(pl + lane * (F + 4));
      const float4* p1 = reinterpret_cast<const float4*>(
          pl + (two ? lane + 32 : lane) * (F + 4));
      const float4* pw = reinterpret_cast<const float4*>(swt + dy * K * F);
      float acc[2][K];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) acc[0][dx] = acc[1][dx] = 0.f;
      if (lane < swp) {
#pragma unroll 2
        for (int q = 0; q < FQ; ++q) {
          const float4 g0 = p0[q];
          const float4 g1 = p1[q];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const float4 wv = pw[dx * FQ + q];
            acc[0][dx] = fmaf(g0.w, wv.w, fmaf(g0.z, wv.z, fmaf(
                g0.y, wv.y, fmaf(g0.x, wv.x, acc[0][dx]))));
            acc[1][dx] = fmaf(g1.w, wv.w, fmaf(g1.z, wv.z, fmaf(
                g1.y, wv.y, fmaf(g1.x, wv.x, acc[1][dx]))));
          }
        }
        float* h = hr + (k % DX_RING) * KK * swp + dy * K * swp + lane;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          h[dx * swp] = acc[0][dx];
          if (two) h[dx * swp + 32] = acc[1][dx];
        }
      }
    } else {
      if (!nxt.done()) convert(nxt, k + 1);
      if (k > 0) gather(prv, k - 1);
    }
    prv = cur;
    cur.next(H);
    if (!nxt.done()) nxt.next(H);
    __syncthreads();  // slot k's h-row and slot k+1's plane are in
    if (issuer && !pc.done()) {  // stage of slot k+1 is free
      issue(pc, kp++);
      pc.next(H);
    }
  }
  if (!tapper && k > 0) gather(prv, k - 1);  // the last slot's output row
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
  const size_t smem = fw_smem_bytes<T>(f);
  const int tiles_w = (wd + fw_tile_px(f) - 1) / fw_tile_px(f);
  const long long ntiles = (long long)n * h * tiles_w;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  auto kern = leaky ? stem_fwd_kernel<T, true> : stem_fwd_kernel<T, false>;
  int sms = 0, per_sm = 0;
  cudaError_t e = prepare(reinterpret_cast<const void*>(kern), smem, NT,
                          &sms, &per_sm);
  if (e != cudaSuccess) return e;
  // persistent blocks, as many as fit; the tiles do not depend on it
  const long long most = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  const int grid = (int)(ntiles < most ? ntiles : most);
  kern<<<grid, NT, smem, s>>>(static_cast<const T*>(x),
                              static_cast<const T*>(w),
                              static_cast<const float*>(b),
                              static_cast<T*>(y), h, wd, f, slope, tiles_w,
                              (int)ntiles);
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
  return sum_partials(static_cast<const float*>(part),
                      static_cast<float*>(out), nblocks, len, s);
}

template <typename T>
cudaError_t dx_t(const void* g, const void* y, const void* w, void* dx, int n,
                 int h, int wd, int f, int mask, float slope,
                 cudaStream_t s) {
  const size_t smem = dx_smem_bytes<T>(f);
  const int sw = dx_swp(f) - 4;
  const int strips = (wd + sw - 1) / sw;
  const long long rows = (long long)n * strips * h;
  auto kern = mask ? stem_dx_kernel<T, true> : stem_dx_kernel<T, false>;
  int sms = 0, per_sm = 0;
  cudaError_t e = prepare(reinterpret_cast<const void*>(kern), smem, DX_NT,
                          &sms, &per_sm);
  if (e != cudaSuccess) return e;
  // as many blocks as fit (one an SM at F = 64), an equal share each
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(rows < fit ? rows : fit);
  const long long share = (rows + grid - 1) / grid;
  if (share > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<grid, DX_NT, smem, s>>>(static_cast<const T*>(g),
                                 static_cast<const T*>(y),
                                 static_cast<const T*>(w), static_cast<T*>(dx),
                                 h, wd, f, slope, strips, rows, (int)share);
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
