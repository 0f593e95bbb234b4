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
// slope, the saved y.  The arithmetic (9*cin FMAs per output value) is below
// the fp32 peak's time (0.04 ms of FMAs for dW's 0.09 ms of bytes at cin 4).
//
// Design: the TPU kernel's plane stack (column-subsampled copies of x made
// outside the kernel), its 8-aligned halo DMA and its one-dot-per-row loop
// exist for Mosaic's lane rules and the MXU.  Here the F axis stays on
// neighbouring threads, so every store of y and every read of g and y is a
// run of whole 128-byte lines.
//   fwd: a block stages the (2*TH+1) x (2*TW+1) x cin halo tile of x once
//        into shared memory, one plane per channel, so the stride-2 taps are
//        plain shared-memory reads; the 9*cin x F weights sit in shared
//        memory; a thread owns 8 pixels of an output row x 4 features in
//        registers, so one weight load feeds 32 FMAs.
//   dW:  a stream, as the stem's dW (conv_stem.cu): at PatchGAN's shape it
//        reads 302 MB (g and y, 134 MB each, and x) for 2.5 GFLOP, so the
//        design keeps bytes in flight.  One persistent block an SM walks the
//        tiles b, b + gridDim.x, ... (a tile: up to 64 output pixels of one
//        output row x all F, 16 KB of g and 16 KB of y at F = 64 in fp32,
//        one contiguous NHWC run each; F > 64 takes fewer pixels, so no
//        feature split); one thread brings each tile into a ring of 4
//        stages with two 1-D bulk copies (the TMA unit, one mbarrier a
//        stage) 3 tiles ahead, and the tile's 3 input rows x 129 columns x
//        cin come 3 tiles ahead through registers into a double buffer, at
//        a fixed row stride (a divide by a constant; with the runtime
//        stride's divides the kernel measured 13% slower).  A thread owns
//        NF features (2 at cin 4, else 4) of a run of consecutive pixels
//        and keeps 9 taps x cin x NF sums and NF db sums in registers over
//        all its tiles (72 at most); it reads each g and y value once.  (The
//        halo-tile kernel before it gave a thread 4 features of one
//        channel, so the cin threads of a feature quad loaded the same g
//        and y, synchronously, and it staged x between two barriers: its
//        loads alone took 1.8x the byte bound.)  The warps of a tile span
//        one or two pixels, so the stride-2 x reads are broadcasts and need
//        no de-interleaved planes.  The leaky select reads the saved output,
//        so the masked cotangent never goes through device memory.  The
//        block's lanes are added in lane order in shared memory, each block
//        writes one partial, and sum_partials_kernel adds them in block
//        order: no atomics, the same bits every run.  512 threads a block,
//        or the pixel loop unrolled by two, measured no faster
//        (tools/thin_s2_variants.py, PERF.md).
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
constexpr int DW_NT = 256;        // threads of a block
constexpr int DW_STAGES = 4;      // ring of tiles in shared memory
constexpr int DW_ELEMS = 4096;    // elements of g (and of y) a stage
constexpr int DW_TPMAX = 64;      // most output pixels a tile
constexpr int DW_XW = 2 * DW_TPMAX + 1;  // most x columns a tile row

// output pixels of a tile: a stage holds DW_ELEMS values of g
__host__ __device__ inline int dw_tile_px(int f) {
  return f * DW_TPMAX <= DW_ELEMS ? DW_TPMAX : DW_ELEMS / f;
}
// features a thread: its 9 * CIN * NF sums (72 at most) stay in registers
template <int CIN>
__host__ __device__ constexpr int dw_nf() { return CIN == 4 ? 2 : 4; }
static_assert(512 / dw_nf<4>() <= DW_NT && 512 / dw_nf<1>() <= DW_NT,
              "a block holds the threads of one pixel at F = 512");

template <typename T, int CIN>
size_t dw_smem_bytes(bool mask, int f) {
  const size_t stream = (mask ? 2 : 1) * DW_STAGES * DW_ELEMS * sizeof(T) +
                        2 * 3 * DW_XW * CIN * sizeof(float) +
                        DW_STAGES * sizeof(uint64_t);
  const size_t red = (KK * CIN + 1) * (size_t)f * sizeof(float);
  return stream > red ? stream : red;
}

// N consecutive fp32 values at a shared-memory address (smem_u32)
template <int N>
__device__ __forceinline__ void lds_f(uint32_t a, float* v) {
  if constexpr (N == 4) {
    lds4<float>(a, v);
  } else if constexpr (N == 2) {
    asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n"
                 : "=f"(v[0]), "=f"(v[1])
                 : "r"(a));
  } else {
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v[0]) : "r"(a));
  }
}
// N (2 or 4) consecutive values of type T at a shared-memory address as fp32
template <typename T, int N>
__device__ __forceinline__ void lds_t(uint32_t a, float* v) {
  if constexpr (N == 4) {
    lds4<T>(a, v);
  } else if constexpr (sizeof(T) == 4) {
    lds_f<2>(a, v);
  } else {
    uint32_t r;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(r) : "r"(a));
    v[0] = __uint_as_float(r << 16);
    v[1] = __uint_as_float(r & 0xffff0000u);
  }
}
// A tile: up to TP output pixels of one output row x all F (g, and y with
// the mask: one contiguous NHWC run each).  Block b takes the tiles
// b, b + gridDim.x, ... in that order.  Thread (lane, fq): features
// fq*NF.. of the lane's run of consecutive pixels of every tile; 9 taps x
// CIN channels x NF features and NF db sums in registers over all of them.
template <typename T, int CIN, bool MASK>
__global__ void __launch_bounds__(DW_NT)
    s2_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const T* __restrict__ y, float* __restrict__ part, int H,
                 int W, int F, float slope, int tiles_w, int ntiles) {
  constexpr int NF = dw_nf<CIN>();
  constexpr int XPT = (3 * DW_XW * CIN + DW_NT - 1) / DW_NT;  // x a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sg = reinterpret_cast<T*>(smem_raw);          // [DW_STAGES][DW_ELEMS]
  T* sy = sg + DW_STAGES * DW_ELEMS;               // the same, for y (MASK)
  float* sx = reinterpret_cast<float*>(sy + (MASK ? DW_STAGES * DW_ELEMS : 0));
                                                   // [2][3][DW_XW][CIN]
  uint64_t* full = reinterpret_cast<uint64_t*>(sx + 2 * 3 * DW_XW * CIN);
  float* sred = reinterpret_cast<float*>(smem_raw);  // [9*CIN+1][F], at the end
  const int HO = H / 2, WO = W / 2;
  const int tid = threadIdx.x;
  const int TPP = F / NF;          // threads a pixel
  const int NL = DW_NT / TPP;      // lanes: runs of pixels of a tile
  const int lane = tid / TPP;
  const int f0 = (tid - lane * TPP) * NF;
  const bool active = lane < NL;
  const int TP = dw_tile_px(F);
  const int xw = 2 * TP + 1;       // x columns of a tile row (of DW_XW)
  const int per = (TP + NL - 1) / NL;
  const int p0 = lane * per;       // the lane's pixels p0 .. p0+per-1
  const int nmine = (int)blockIdx.x < ntiles
                        ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;

  auto locate = [&](int k, int& n, int& oy, int& ox0) {
    const int t = blockIdx.x + k * gridDim.x;
    const int r = t / tiles_w;
    ox0 = (t - r * tiles_w) * TP;
    oy = r % HO;
    n = r / HO;
  };
  // thread 0 copies tile k into stage k % DW_STAGES
  auto issue = [&](int k) {
    if (tid != 0 || k >= nmine) return;
    int n, oy, ox0;
    locate(k, n, oy, ox0);
    const int np = min(TP, WO - ox0);
    const size_t off = (((size_t)n * HO + oy) * WO + ox0) * F;
    const uint32_t bytes = np * F * sizeof(T);  // dW tile
    uint64_t* bar = full + k % DW_STAGES;
    fence_proxy_async();  // after the block's reads of this stage
    mbar_expect_tx(bar, (MASK ? 2 : 1) * bytes);
    if (bytes == 0) return;
    bulk_copy(sg + (k % DW_STAGES) * DW_ELEMS, g + off, bytes, bar);
    if (MASK) bulk_copy(sy + (k % DW_STAGES) * DW_ELEMS, y + off, bytes, bar);
  };
  // x rows 2oy-1 .. 2oy+1, columns 2ox0-1 .. 2ox0+2TP-1 of tile k (zeros
  // outside the image), one contiguous NHWC run a row, into registers and
  // from there into sx[k % 2]
  auto load_x = [&](int k, float (&xr)[XPT]) {
    if (k >= nmine) return;
    int n, oy, ox0;
    locate(k, n, oy, ox0);
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * DW_NT;
      const int r = i / (DW_XW * CIN);  // rows DW_XW columns apart
      const int e = i - r * DW_XW * CIN;
      const int gh = 2 * oy - 1 + r;
      const int gw = 2 * ox0 - 1 + e / CIN;
      const bool xrow = r < 3 && e < xw * CIN && gh >= 0 && gh < H &&
                        gw >= 0 && gw < W;
      xr[j] = xrow ? load_early(x + ((size_t)(n * H + gh) * W + 2 * ox0 - 1) *
                                        CIN + e)
                   : 0.f;
    }
  };
  auto store_x = [&](int k, const float (&xr)[XPT]) {
    if (k >= nmine) return;
    float* d = sx + (k & 1) * 3 * DW_XW * CIN;
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * DW_NT;
      if (i < 3 * DW_XW * CIN) d[i] = xr[j];
    }
  };

  float acc[KK][CIN][NF];
  float dbv[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    dbv[f] = 0.f;
#pragma unroll
    for (int t = 0; t < KK; ++t)
#pragma unroll
      for (int c = 0; c < CIN; ++c) acc[t][c][f] = 0.f;
  }

  auto compute = [&](int k) {
    if (!active) return;
    int n, oy, ox0;
    locate(k, n, oy, ox0);
    const int np = min(min(TP, WO - ox0) - p0, per);  // this lane's pixels
    const uint32_t ga =
        smem_u32(sg + (k % DW_STAGES) * DW_ELEMS + p0 * F + f0);
    const uint32_t ya =
        smem_u32(sy + (k % DW_STAGES) * DW_ELEMS + p0 * F + f0);
    const uint32_t xsa = smem_u32(sx + (k & 1) * 3 * DW_XW * CIN) +
                        2 * p0 * CIN * (int)sizeof(float);
    for (int p = 0; p < np; ++p) {
      float gm[NF];
      lds_t<T, NF>(ga + p * F * (int)sizeof(T), gm);
      if (MASK) {
        float yv[NF];
        lds_t<T, NF>(ya + p * F * (int)sizeof(T), yv);
#pragma unroll
        for (int f = 0; f < NF; ++f)
          if (!(yv[f] >= 0.f)) gm[f] *= slope;
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) dbv[f] += gm[f];
#pragma unroll
      for (int dy = 0; dy < K; ++dy)  // dW taps
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          float xv[CIN];
          lds_f<CIN>(xsa + ((dy * DW_XW + 2 * p + dx) * CIN) * 4, xv);
#pragma unroll
          for (int c = 0; c < CIN; ++c)
#pragma unroll
            for (int f = 0; f < NF; ++f)
              acc[dy * K + dx][c][f] =
                  fmaf(xv[c], gm[f], acc[dy * K + dx][c][f]);
        }
    }
  };

  // one tile: its x rows come from registers loaded two tiles earlier
  auto step = [&](int k, float (&xr)[XPT]) {
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
  float xa[XPT], xb[XPT];
  for (int s = 0; s < DW_STAGES - 1; ++s) issue(s);
  load_x(0, xa);
  store_x(0, xa);
  load_x(1, xa);
  load_x(2, xb);
  for (int k = 0; k < nmine; k += 2) {  // two register sets, in turn
    step(k, xa);
    if (k + 1 < nmine) step(k + 1, xb);
  }
  // every thread has waited on its last tile (the step's barrier), so no
  // phase is pending: the barriers go before sred may write over them
  if (tid == 0)
    for (int s = 0; s < DW_STAGES; ++s) mbar_inval(full + s);
  // the block's lanes added in lane order
  for (int rnd = 0; rnd < NL; ++rnd) {
    __syncthreads();
    if (active && lane == rnd) {
#pragma unroll
      for (int t = 0; t <= KK; ++t)
#pragma unroll
        for (int c = 0; c < (t < KK ? CIN : 1); ++c)
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            const int i = (t * CIN + c) * F + f0 + f;
            const float v = t < KK ? acc[t < KK ? t : 0][c][f] : dbv[f];
            sred[i] = (rnd == 0 ? 0.f : sred[i]) + v;
          }
    }
  }
  __syncthreads();
  const int len = (KK * CIN + 1) * F;
  for (int i = tid; i < len; i += DW_NT)
    part[(size_t)blockIdx.x * len + i] = sred[i];
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
  const size_t smem = dw_smem_bytes<T, CIN>(mask, f);
  const int tiles_w = (wd / 2 + dw_tile_px(f) - 1) / dw_tile_px(f);
  const long long ntiles = (long long)n * (h / 2) * tiles_w;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  auto kern = mask ? s2_dw_kernel<T, CIN, true> : s2_dw_kernel<T, CIN, false>;
  int sms = 0, per_sm = 0;
  cudaError_t e = prepare(reinterpret_cast<const void*>(kern), smem, DW_NT,
                          &sms, &per_sm);
  if (e != cudaSuccess) return e;
  kern<<<nblocks, DW_NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(y), static_cast<float*>(part), h, wd, f, slope,
      tiles_w, (int)ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int len = (KK * CIN + 1) * f;
  return sum_partials(static_cast<const float*>(part),
                      static_cast<float*>(out), nblocks, len, s);
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
// mask != 0), g and y 16-byte aligned (their tiles are bulk copies); part:
// fp32 scratch of nblocks*(9*cin+1)*f (one block an SM is the design); out:
// fp32
// (9*cin+1, f), rows 0..9*cin-1 dW as (3,3,cin,f), the last row db.
extern "C" int conv_s2_dw_launch(const void* x, const void* g, const void* y,
                                 void* part, void* out, int nblocks, int n,
                                 int h, int wd, int cin, int f, int mask,
                                 float slope, int dtype, void* stream) {
  if (bad_shape(n, h, wd, f) || nblocks <= 0 ||
      (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(y)) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dw_t<float>(x, g, y, part, out, nblocks, n, h, wd, cin, f, mask,
                       slope, s);
  if (dtype == kBF16)
    return dw_t<__nv_bfloat16>(x, g, y, part, out, nblocks, n, h, wd, cin, f,
                               mask, slope, s);
  return cudaErrorInvalidValue;
}
