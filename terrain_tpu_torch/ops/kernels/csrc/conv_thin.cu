// conv_thin: 3x3 stride-1 zero-padded convolution with few output channels.
//
// Replaces the TPU kernel terrain_tpu/ops/pallas/conv_thin.py
// (_fwd_kernel via _conv_thin_fwd_pallas / _thin_call), and its gradients:
//   conv_thin_dx_launch <- _conv_thin_dx_pallas (the forward body run with
//                          the channel roles swapped and rot180 weights)
//   conv_thin_dw_launch <- _dw_kernel via _conv_thin_dw_pallas
//
//   y[n,h,w,o] = sum_{dy,dx,i} x[n,h+dy-1,w+dx-1,i] * w[dy,dx,i,o]
//   dX[n,h,w,i]  = sum_{dy,dx,o} g[n,h+1-dy,w+1-dx,o] * w[dy,dx,i,o]
//   dW[dy,dx,i,o] = sum_{n,h,w} x[n,h+dy-1,w+dx-1,i] * g[n,h,w,o]   (fp32)
//   x: (N,H,W,C) NHWC, C <= 64;  w: (3,3,C,F) HWIO, F <= 8;  no bias.
//   Products of x.dtype values, summed in fp32; y and dX in x.dtype.
//
// What bounds them on the card: bytes.  At (4,256,256,64) fp32 each reads
// 67 MB of x (or writes it, dX) and 4.2 MB of y or g (about 21 us at
// 3.35 TB/s) for 1.2 GFLOP (about 18 us on the fp32 CUDA cores; the 4
// live output channels leave no room for tensor-core tiles).
//
// All three are row streams (the TPU kernel's W-on-lanes transposes and
// (1,7) edge padding have no counterpart here).  The image is cut into
// column strips of SW = 64 outputs; persistent blocks each walk an equal
// share of the (image, strip, row) order down the strips, so an input row
// is read once except where a share starts a strip (two halo rows) and at
// the strips' halo columns: 1.10-1.16x the bytes of x (of g, for dX).  In
// the forward and dW a strip row with its halo (66 pixels x C, one
// contiguous NHWC run) comes into a ring of shared-memory stages by one 1-D
// bulk copy (the TMA unit) issued by one thread 3 rows (fp32; bf16 7)
// ahead, completing on the stage's mbarrier; columns and rows off the image
// are not copied, and the readers take zeros there.  With C % 8 == 0 every
// pixel is a multiple of 16 bytes, so every copy is aligned.  One
// __syncthreads a step.  Reads go through 32-bit shared addresses (lds4),
// so the compiler keeps no generic pointer to rebuild at each masked load.
// NHWC puts a pixel's channels in consecutive banks, so lanes go over
// channels: 16 lanes x 4 channels (one conflict-free 16-byte access) a
// pixel.
//   fwd: a thread takes a run of 8 pixels (4 at F > 4) of one output row
//        over its 4 channels: the run's window of 10 x values a kernel row
//        in registers, the weights as fp32 [9][F][C] in shared memory, 32
//        sums; the 16 lanes of a pixel's channels are then added by a
//        reduce-scatter (4 shuffle steps, 30 shuffles), each lane keeping
//        two sums, which it writes.  Two rows a step (F <= 4), two blocks
//        an SM.  Fixed orders: the same bits every run.
//   dX:  the forward with the roles swapped: the same walk, runs and row
//        groups, the lanes over the OUTPUT channels, so a half-warp writes
//        one pixel's C channels as one contiguous run (256 bytes at C = 64
//        in fp32) and every sector it touches is full; the contraction over
//        F stays inside the lane (no shuffles).  g's strip rows (66 pixels
//        x F; a bf16 row at F = 4, or any at F = 1, is no whole number of
//        16-byte pieces) come by plain loads a step ahead into a ring of
//        2R+2 fp32 stages, broadcast to the 16 lanes; the weights are the
//        forward's table read at the rotated tap.  Two blocks an SM (128
//        registers).  The halo-tile kernel it replaces (one pixel a thread,
//        halo tiles, 8 channels of 16-byte stores 256 bytes apart) spent
//        as long on its half-filled stores alone as on its products alone.
//        Staging the output row in shared memory and writing it by one
//        bulk store measured no better than the lanes' own stores (4%
//        faster in fp32, 6% slower in bf16; tools/thin_s2_variants.py,
//        PERF.md), so the lanes store.
//   dW:  three groups of threads, one a kernel row dy; a thread takes a
//        run of 16 pixels of one output row over its 4 channels and keeps
//        3 taps x 4 channels x F sums in registers over its block's whole
//        share (48 at F = 4), 4 pixels at a time from a window of 6; g's
//        row comes through plain loads a step ahead into a double buffer
//        (g rows of a ragged W with small F are not 16-byte aligned), one
//        broadcast load a pixel.  The block's runs are added in run order
//        in shared memory, each block writes one partial, and
//        sum_partials_kernel adds them in a fixed order (no atomics: the
//        same bits every run).  Two blocks an SM.
// Launch attributes (shared-memory allowance, SM count, blocks an SM) are
// set once per kernel and size (prepare, common.cuh).
#include "common.cuh"

namespace {

// ------------------------------------------------ the row streams
constexpr int SW = 64;          // output columns of a strip
constexpr int SWP = SW + 2;     // pixels of a strip row, halo included
constexpr int QL = 16;          // lanes over a pixel's channels, 4 each

// stages of the ring: fp32 6 rows (3 in flight), bf16 10 (7 in flight)
template <typename T>
__host__ __device__ constexpr int ring_stages() {
  return sizeof(T) == 4 ? 6 : 10;
}

// A block's share of the output rows in (image, strip, row) order, cut into
// segments at strip ends.  A segment of output rows [r0, r1) takes the
// r1-r0+2 input rows r0-1..r1 ("slots" j = 0..); slot j >= 2 completes
// output row r0+j-2.
struct RowCursor {
  long long lin, end;  // next output row of the share, end of the share
  int H, strips;
  int n, cb, r0, r1, j;  // image, image column of the strip row's pixel 0,
                         // rows of the segment, slot
  __device__ void segment() {
    const int ns = (int)(lin / H);  // image * strips + strip
    n = ns / strips;
    cb = (ns - n * strips) * SW - 1;
    r0 = (int)(lin - (long long)ns * H);
    r1 = (int)min((long long)H, r0 + (end - lin));
    j = 0;
  }
  __device__ void init(long long a, long long e, int h, int s) {
    lin = a;
    end = e;
    H = h;
    strips = s;
    if (lin < end) segment();
  }
  __device__ bool done() const { return lin >= end; }
  __device__ void next() {
    if (++j == r1 - r0 + 2) {
      lin += r1 - r0;
      if (lin < end) segment();
    }
  }
};

// The input rows of a block's slots through a ring of S stages in shared
// memory: one thread copies each strip row with its halo (one contiguous
// NHWC run) by one 1-D bulk copy that completes on the stage's mbarrier.
// Columns and rows off the image are not copied; readers take zeros there.
template <typename T, int S>
struct RowRing {
  const T* x;
  T* stage;        // [S][SWP * C]
  uint64_t* full;  // [S]
  int H, W, C;
  uint32_t base;   // smem_u32(stage)

  // the issuing thread: the input row of slot c into stage k % S
  __device__ void issue(const RowCursor& c, int k) const {
    const int gh = c.r0 - 1 + c.j;
    uint64_t* bar = full + k % S;
    fence_proxy_async();  // after the block's reads of this stage
    if (gh < 0 || gh >= H) {
      mbar_expect_tx(bar, 0);
      return;
    }
    const int lo = max(c.cb, 0);
    const int hi = min(c.cb + SWP, W);
    const uint32_t bytes = (hi - lo) * C * sizeof(T);
    mbar_expect_tx(bar, bytes);
    bulk_copy(stage + ((size_t)(k % S) * SWP + lo - c.cb) * C,
              x + (((size_t)c.n * H + gh) * W + lo) * C, bytes, bar);
  }
  __device__ void wait(int k) const {
    mbar_wait(full + k % S, (k / S) & 1);
  }
  // shared-memory address (lds4) of slot k's row
  __device__ uint32_t row(int k) const {
    return base + (k % S) * SWP * C * (int)sizeof(T);
  }
};

// The columns cb .. cb+n-1 that lie in the image [0, W), one bit each
__device__ __forceinline__ uint32_t in_image(int cb, int n, int W) {
  const int lo = max(0, -cb);
  const int hi = min(n, W - cb);
  return hi <= lo ? 0u : ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// One step of a reduce-scatter across the 16 lanes of a half-warp: of the
// 2L values v[0..2L), the lane keeps the half its bit m selects, summed
// with its partner's (lane ^ m).  After the steps m = 8, 4, 2, 1 lane q
// holds the sums of values 2q and 2q+1 in v[0], v[1].
template <int L>
__device__ __forceinline__ void fold(float* v, int lane, int m) {
  const bool up = lane & m;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const float send = up ? v[i] : v[i + L];
    const float keep = up ? v[i + L] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// forward: a thread's run of P pixels x F outputs (32 sums at most); a
// step computes fwd_rows output rows, one a group of SW / P * 16 threads
// (two groups at F <= 4, 256 threads: 128 registers a thread)
template <int F>
__host__ __device__ constexpr int run_px() { return F <= 4 ? 8 : 4; }
template <int F>
__host__ __device__ constexpr int fwd_rows() { return F <= 4 ? 2 : 1; }
template <int F>
__host__ __device__ constexpr int fwd_threads() {
  return fwd_rows<F>() * SW / run_px<F>() * QL;
}

template <typename T, int F>
size_t fwd_smem_bytes(int c) {
  return sizeof(float) * 9 * F * c +
         sizeof(T) * (size_t)ring_stages<T>() * SWP * c +
         sizeof(uint64_t) * ring_stages<T>();
}

// w (3,3,C,F) HWIO into shared memory as fp32 [9][F][C] (a pixel's 4
// channels of one output are then one float4), 8 loads in flight a thread.
template <int NT, typename T>
__device__ __forceinline__ void load_weights(float* sw, const T* w, int C,
                                             int F, int tid) {
  const int len = 9 * F * C;
  for (int i0 = 0; i0 < len; i0 += 8 * NT) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * NT + tid;
      const int c = i % C;
      const int o = (i / C) % F;
      const int t = i / (C * F);
      v[u] = i < len ? to_f(w[(t * C + c) * F + o]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * NT + tid < len) sw[i0 + u * NT + tid] = v[u];
  }
}

// Row group gr takes the step's output row gr; half-warp h of its warp wp
// the strip's P-pixel run wp*2+h; lane q the channels 4q..4q+3 (lanes past
// C/4 only join the sums).
template <typename T, int F>
__global__ void __launch_bounds__(fwd_threads<F>())
    thin_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int H, int W, int C, int strips,
                    long long rows, int share) {
  constexpr int S = ring_stages<T>();
  constexpr int P = run_px<F>();
  constexpr int NT = fwd_threads<F>();
  constexpr int R = fwd_rows<F>();
  constexpr int GT = NT / R;  // threads of a row group
  static_assert(S >= R + 3, "the ring holds a step and its halo");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sw = reinterpret_cast<float*>(smem_raw);   // [9][F][C]
  T* stage = reinterpret_cast<T*>(sw + 9 * F * C);  // [S][SWP * C]
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + S * SWP * C);
  const int tid = threadIdx.x;
  const long long a = (long long)blockIdx.x * share;
  if (a >= rows) return;
  const long long e = min(a + share, rows);
  const RowRing<T, S> ring{x, stage, full, H, W, C, smem_u32(stage)};
  RowCursor pc, cur;  // the slots to issue, the slots to compute
  pc.init(a, e, H, strips);
  cur.init(a, e, H, strips);
  int kp = 0;  // the next slot to issue
  // the first rows are under way while the weights come in
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
    for (; kp < S - 2 && !pc.done(); ++kp, pc.next()) ring.issue(pc, kp);
  }
  load_weights<NT>(sw, w, C, F, tid);
  __syncthreads();

  const int gr = tid / GT;
  const int lane = tid & 31;
  const int q = lane & 15;
  const int run = (tid % GT) >> 4;
  const bool active = 4 * q < C;
  for (int k = 0; !cur.done(); k += R) {
    // every thread is done with the slots before k-2, whose stages are
    // refilled next
    __syncthreads();
    if (tid == 0)
      for (; kp < k + S - 2 && !pc.done(); ++kp, pc.next())
        ring.issue(pc, kp);
    // this thread's slot: k + gr
    RowCursor c = cur;
    for (int i = 0; i < R; ++i) {
      if (!cur.done()) ring.wait(k + i);
      if (i < gr) c.next();
      cur.next();
    }
    if (c.done() || c.j < 2) continue;
    const int ks = k + gr;
    const int r = c.r0 + c.j - 2;   // output row, from slots ks-2..ks
    const int cb = c.cb + run * P;  // image column of window 0
    float acc[P * F];
#pragma unroll
    for (int i = 0; i < P * F; ++i) acc[i] = 0.f;
    if (active && cb + 1 < W) {
      const uint32_t cols = in_image(cb, P + 2, W);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int gh = r - 1 + dy;
        if (gh < 0 || gh >= H) continue;
        const uint32_t xa =
            ring.row(ks - 2 + dy) + (run * P * C + 4 * q) * (int)sizeof(T);
        float xv[P + 2][4];
#pragma unroll
        for (int t = 0; t < P + 2; ++t) {
          if (cols >> t & 1u) {
            lds4<T>(xa + t * C * (int)sizeof(T), xv[t]);
          } else {
            xv[t][0] = xv[t][1] = xv[t][2] = xv[t][3] = 0.f;
          }
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float wv[F][4];
#pragma unroll
          for (int o = 0; o < F; ++o)
            load4(sw + ((dy * 3 + dx) * F + o) * C + 4 * q, wv[o]);
          // channel outermost: a run of P*F FMAs shares one x operand
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int p = 0; p < P; ++p)
#pragma unroll
              for (int o = 0; o < F; ++o)
                acc[p * F + o] =
                    fmaf(xv[p + dx][cc], wv[o][cc], acc[p * F + o]);
        }
      }
    }
    // the run's P*F sums over the 16 lanes' channels, in a fixed order
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = i < P * F ? acc[i % (P * F)] : 0.f;
    fold<16>(v, lane, 8);
    fold<8>(v, lane, 4);
    fold<4>(v, lane, 2);
    fold<2>(v, lane, 1);
    T* yr = y + (((size_t)c.n * H + r) * W + cb + 1) * F;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = 2 * q + u;
      if (i < P * F && cb + 1 + i / F < W) yr[i] = from_f<T>(v[u]);
    }
  }
}

// The (image, strip, row) order of the forward and dW: `strips` column
// strips an image, `rows` output rows of strips in all, an equal share of
// them for each of `grid` blocks.
struct Walk {
  int strips, grid, share;
  long long rows;
};

inline cudaError_t walk(int n, int h, int wd, long long blocks, Walk* wk) {
  wk->strips = (wd + SW - 1) / SW;
  wk->rows = (long long)n * wk->strips * h;
  wk->grid = (int)(wk->rows < blocks ? wk->rows : blocks);
  const long long share = (wk->rows + wk->grid - 1) / wk->grid;
  if (share > 0x7fffffff) return cudaErrorInvalidValue;
  wk->share = (int)share;
  return cudaSuccess;
}

template <typename T, int F>
cudaError_t fwd_t(const void* x, const void* w, void* y, int n, int h,
                  int wd, int c, cudaStream_t s) {
  const size_t smem = fwd_smem_bytes<T, F>(c);
  auto kern = thin_fwd_kernel<T, F>;
  int sms = 0, per_sm = 0;
  cudaError_t e = prepare(reinterpret_cast<const void*>(kern), smem,
                          fwd_threads<F>(), &sms, &per_sm);
  if (e != cudaSuccess) return e;
  // persistent blocks, as many as fit (two an SM at C = 64, F <= 4)
  Walk wk;
  e = walk(n, h, wd, (long long)sms * (per_sm > 0 ? per_sm : 1), &wk);
  if (e != cudaSuccess) return e;
  kern<<<wk.grid, fwd_threads<F>(), smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      h, wd, c, wk.strips, wk.rows, wk.share);
  return cudaGetLastError();
}

// dX: the forward's walk, runs and row groups with the channel roles
// swapped.  Lane q owns the output channels 4q..4q+3 (lanes past C/4 idle);
// the contraction over g's F channels stays inside the lane.  g's strip
// rows (SWP pixels x F, as fp32 padded to DX_FP floats a pixel) come through
// plain loads a step ahead into a ring of 2R+2 stages, so one __syncthreads
// a step separates the stages written from the stages read.  The weights,
// rotated by 180 degrees through the tap index, are load_weights' [9][F][C]
// table.

template <int F>
__host__ __device__ constexpr int dx_fp() { return F <= 4 ? 4 : 8; }
template <int F>
__host__ __device__ constexpr int dx_stages() { return 2 * fwd_rows<F>() + 2; }

template <typename T, int F>
size_t dx_smem_bytes(int c) {
  return sizeof(float) * (9 * F * c + dx_stages<F>() * SWP * dx_fp<F>());
}

template <typename T, int F>
__global__ void __launch_bounds__(fwd_threads<F>())
    thin_dx_kernel(const T* __restrict__ g, const T* __restrict__ w,
                   T* __restrict__ dx, int H, int W, int C, int strips,
                   long long rows, int share) {
  constexpr int P = run_px<F>();
  constexpr int NT = fwd_threads<F>();
  constexpr int R = fwd_rows<F>();
  constexpr int GT = NT / R;  // threads of a row group
  constexpr int FP = dx_fp<F>();
  constexpr int S = dx_stages<F>();
  constexpr int GV = SWP * F;                 // g values of a slot
  constexpr int GPT = (R * GV + NT - 1) / NT;  // of a step, a thread's
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sw = reinterpret_cast<float*>(smem_raw);     // [9][F][C]
  float* sg = sw + 9 * F * C;                      // [S][SWP][FP]
  const int tid = threadIdx.x;
  const long long a = (long long)blockIdx.x * share;
  if (a >= rows) return;
  const long long e = min(a + share, rows);
  RowCursor cur, gc;  // the slots to compute, the slots to load
  cur.init(a, e, H, strips);
  gc = cur;
  // g of the step's R slots from gc on, fp32, into registers (zeros off
  // the image and past the share); then into stages k.. % S
  float gr[GPT];
  auto load_g = [&]() {
    // per slot of the step: the row's offset in g and whether it is read
    long long base[R];
    int cb[R];
    bool ok[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int gh = gc.r0 - 1 + gc.j;
      ok[u] = !gc.done() && gh >= 0 && gh < H;
      cb[u] = gc.cb;
      base[u] = (((long long)gc.n * H + gh) * W + gc.cb) * F;
      gc.next();
    }
#pragma unroll
    for (int v = 0; v < GPT; ++v) {
      const int i = tid + v * NT;
      const int u = min(i / GV, R - 1);  // the step's slot
      const int px = (i - u * GV) / F;
      const int col = cb[u] + px;
      const bool grow = i < R * GV && ok[u] && col >= 0 && col < W;
      gr[v] = grow ? to_f(g[base[u] + i - u * GV]) : 0.f;
    }
  };
  auto store_g = [&](int k) {
#pragma unroll
    for (int v = 0; v < GPT; ++v) {
      const int i = tid + v * NT;
      const int u = i / GV;
      const int px = (i - u * GV) / F;
      if (u < R)
        sg[(((k + u) % S) * SWP + px) * FP + i - u * GV - px * F] = gr[v];
    }
  };
  load_weights<NT>(sw, w, C, F, tid);
  load_g();

  const int gr_ = tid / GT;
  const int q = tid & 15;
  const int run = (tid % GT) >> 4;
  const bool active = 4 * q < C;
  const uint32_t swa = smem_u32(sw) + 16 * q;
  for (int k = 0; !cur.done(); k += R) {
    // the stages written here were last read a step ago (2R+2 stages)
    store_g(k);
    __syncthreads();
    load_g();
    RowCursor c = cur;  // this thread's slot: k + gr_
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < gr_) c.next();
      cur.next();
    }
    const int r = c.r0 + c.j - 2;    // output row, from slots k+gr_-2..
    const int col0 = c.cb + 1 + run * P;  // image column of pixel 0
    const bool row = !c.done() && c.j >= 2 && col0 < W;
    float acc[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
      acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
    if (row && active) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {  // dX taps
        const int gh = r - 1 + dy;
        if (gh < 0 || gh >= H) continue;
        const uint32_t ga =
            smem_u32(sg) + (((k + gr_ - 2 + dy) % S) * SWP + run * P) * FP * 4;
        float gv[P + 2][FP];
#pragma unroll
        for (int t = 0; t < P + 2; ++t) {
          lds4<float>(ga + t * FP * 4, gv[t]);
          if (FP == 8) lds4<float>(ga + (t * FP + 4) * 4, gv[t] + 4);
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int o = 0; o < F; ++o) {
            // w[2-dy, 2-dx, 4q.., o]: tap 8 - (dy*3+dx) of the table
            float wv[4];
            lds4<float>(swa + ((8 - dy * 3 - dx) * F + o) * C * 4, wv);
#pragma unroll
            for (int p = 0; p < P; ++p)
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
                acc[p][cc] = fmaf(gv[p + dx][o], wv[cc], acc[p][cc]);
          }
      }
    }
    if (row && active) {  // dX row out
      T* out = dx + (((size_t)c.n * H + r) * W + col0) * C + 4 * q;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (col0 + p < W) store4(out + p * C, acc[p]);
    }
  }
}

template <typename T, int F>
cudaError_t dx_t(const void* g, const void* w, void* dx, int n, int h,
                 int wd, int c, cudaStream_t s) {
  const size_t smem = dx_smem_bytes<T, F>(c);
  auto kern = thin_dx_kernel<T, F>;
  int sms = 0, per_sm = 0;
  cudaError_t e = prepare(reinterpret_cast<const void*>(kern), smem,
                          fwd_threads<F>(), &sms, &per_sm);
  if (e != cudaSuccess) return e;
  // persistent blocks, as many as fit
  Walk wk;
  e = walk(n, h, wd, (long long)sms * (per_sm > 0 ? per_sm : 1), &wk);
  if (e != cudaSuccess) return e;
  kern<<<wk.grid, fwd_threads<F>(), smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), static_cast<T*>(dx),
      h, wd, c, wk.strips, wk.rows, wk.share);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* g, const void* w, void* dx, int n, int h,
                      int wd, int c, int f, cudaStream_t s) {
  switch (f) {
    case 1: return dx_t<T, 1>(g, w, dx, n, h, wd, c, s);
    case 2: return dx_t<T, 2>(g, w, dx, n, h, wd, c, s);
    case 3: return dx_t<T, 3>(g, w, dx, n, h, wd, c, s);
    case 4: return dx_t<T, 4>(g, w, dx, n, h, wd, c, s);
    case 5: return dx_t<T, 5>(g, w, dx, n, h, wd, c, s);
    case 6: return dx_t<T, 6>(g, w, dx, n, h, wd, c, s);
    case 7: return dx_t<T, 7>(g, w, dx, n, h, wd, c, s);
    case 8: return dx_t<T, 8>(g, w, dx, n, h, wd, c, s);
    default: return cudaErrorInvalidValue;
  }
}

// dW: three groups of threads, one a kernel row dy; in a group half-warp
// h of warp wp takes the strip's DW_P-pixel run wp*2+h, lane q the
// channels 4q..4q+3.  A thread keeps 3 taps x 4 channels x F sums over its
// block's whole share, and takes its run 4 pixels at a time.
constexpr int DW_P = 16;                 // pixels of a run
constexpr int DW_RUNS = SW / DW_P;       // runs of a strip row
constexpr int DW_NT = 3 * DW_RUNS * QL;  // threads of a block
constexpr int GP = 8;                    // floats of a pixel in the g rows
constexpr int DW_GPT = (SW * 8 + DW_NT - 1) / DW_NT;  // g values a thread

template <typename T>
size_t dw_smem_bytes(int c) {
  return sizeof(T) * (size_t)ring_stages<T>() * SWP * c +
         sizeof(float) * 2 * SW * GP + sizeof(uint64_t) * ring_stages<T>();
}

template <typename T, int F>
__global__ void __launch_bounds__(DW_NT)
    thin_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   float* __restrict__ part, int H, int W, int C,
                   int strips, long long rows, int share) {
  constexpr int S = ring_stages<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);  // [S][SWP * C]
  float* sg = reinterpret_cast<float*>(stage + S * SWP * C);  // [2][SW][GP]
  uint64_t* full = reinterpret_cast<uint64_t*>(sg + 2 * SW * GP);
  float* sred = reinterpret_cast<float*>(smem_raw);  // [9][F][C], at the end
  const int tid = threadIdx.x;
  const long long a = min((long long)blockIdx.x * share, rows);
  const long long e = min(a + share, rows);  // a block past the rows: zeros
  const RowRing<T, S> ring{x, stage, full, H, W, C, smem_u32(stage)};
  RowCursor pc, cur;  // the slots to issue, the slots to compute
  pc.init(a, e, H, strips);
  cur.init(a, e, H, strips);
  int kp = 0;  // the next slot to issue
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
    for (; kp < S - 2 && !pc.done(); ++kp, pc.next()) ring.issue(pc, kp);
  }
  // g of the output row that slot c completes, fp32, into registers (zeros
  // past the image and for the halo slots), and from there into sg[buf]
  float gr[DW_GPT];
  auto load_g = [&](const RowCursor& c) {
    const bool row = !c.done() && c.j >= 2;
    const T* gs = g;
    int col = 0;
    if (row) {
      col = c.cb + 1;
      gs += (((size_t)c.n * H + c.r0 + c.j - 2) * W + col) * F;
    }
#pragma unroll
    for (int u = 0; u < DW_GPT; ++u) {
      const int i = tid + u * DW_NT;
      gr[u] = row && i < SW * F && col + i / F < W ? to_f(gs[i]) : 0.f;
    }
  };
  auto store_g = [&](int buf) {
#pragma unroll
    for (int u = 0; u < DW_GPT; ++u) {
      const int i = tid + u * DW_NT;
      if (i < SW * F) sg[(buf * SW + i / F) * GP + i % F] = gr[u];
    }
  };
  RowCursor gc = cur;  // two slots ahead of cur in the loop
  load_g(gc);
  store_g(0);
  gc.next();
  load_g(gc);
  gc.next();

  const int dy = tid / (DW_RUNS * QL);
  const int lane = tid & 31;
  const int q = lane & 15;
  const int run = (tid % (DW_RUNS * QL)) >> 4;
  const bool active = 4 * q < C;
  float acc[3][4][F];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int o = 0; o < F; ++o) acc[dx][cc][o] = 0.f;
  for (int k = 0; !cur.done(); ++k, cur.next()) {
    // every thread is done with slot k-3 and with g buffer (k+1) % 2
    __syncthreads();
    if (tid == 0)
      for (; kp < k + S - 2 && !pc.done(); ++kp, pc.next())
        ring.issue(pc, kp);
    store_g((k + 1) & 1);
    load_g(gc);
    gc.next();
    ring.wait(k);
    if (cur.j < 2) continue;
    const int gh = cur.r0 + cur.j - 3 + dy;  // this group's input row
    const int cb = cur.cb + run * DW_P;      // image column of window 0
    if (!active || gh < 0 || gh >= H || cb + 1 >= W) continue;
    const uint32_t xa =
        ring.row(k - 2 + dy) + (run * DW_P * C + 4 * q) * (int)sizeof(T);
    const uint32_t ga = smem_u32(sg) + ((k & 1) * SW + run * DW_P) * GP * 4;
    const uint32_t cols = in_image(cb, DW_P + 2, W);
#pragma unroll 1
    for (int p0 = 0; p0 < DW_P; p0 += 4) {
      float xv[6][4];  // image columns cb+p0 .. cb+p0+5
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        if (cols >> (p0 + t) & 1u) {
          lds4<T>(xa + (p0 + t) * C * (int)sizeof(T), xv[t]);
        } else {
          xv[t][0] = xv[t][1] = xv[t][2] = xv[t][3] = 0.f;
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float gv[8];
        lds4<float>(ga + (p0 + p) * GP * 4, gv);
        if (F > 4) lds4<float>(ga + ((p0 + p) * GP + 4) * 4, gv + 4);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int o = 0; o < F; ++o)
              acc[dx][cc][o] = fmaf(xv[p + dx][cc], gv[o], acc[dx][cc][o]);
      }
    }
  }
  // the block's runs of each group added in run order (channels fastest,
  // a thread's 4 as one float4), then written in the HWIO order
  for (int rnd = 0; rnd < DW_RUNS; ++rnd) {
    __syncthreads();
    if (active && run == rnd) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int o = 0; o < F; ++o) {
          float* sp = sred + ((dy * 3 + dx) * F + o) * C + 4 * q;
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (rnd != 0) load4(sp, v);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) v[cc] += acc[dx][cc][o];
          store4(sp, v);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < 9 * C * F; i += DW_NT) {
    const int o = i % F;
    const int c = (i / F) % C;
    const int t = i / (C * F);
    part[(size_t)blockIdx.x * 9 * C * F + i] = sred[(t * F + o) * C + c];
  }
}

template <typename T, int F>
cudaError_t dw_t(const void* x, const void* g, void* part, void* dw,
                 int nblocks, int n, int h, int wd, int c, cudaStream_t s) {
  const size_t smem = dw_smem_bytes<T>(c);
  auto kern = thin_dw_kernel<T, F>;
  int sms = 0, per_sm = 0;
  cudaError_t e = prepare(reinterpret_cast<const void*>(kern), smem, DW_NT,
                          &sms, &per_sm);
  if (e != cudaSuccess) return e;
  // every block writes its partial, the ones past the rows zeros
  Walk wk;
  e = walk(n, h, wd, nblocks, &wk);
  if (e != cudaSuccess) return e;
  kern<<<nblocks, DW_NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(part), h, wd, c, wk.strips, wk.rows, wk.share);
  // a refused launch stays the last error through the second one
  const int len = 9 * c * F;
  return sum_partials(static_cast<const float*>(part),
                      static_cast<float*>(dw), nblocks, len, s);
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* g, void* part, void* dw,
                      int nblocks, int n, int h, int wd, int c, int f,
                      cudaStream_t s) {
  switch (f) {
    case 1: return dw_t<T, 1>(x, g, part, dw, nblocks, n, h, wd, c, s);
    case 2: return dw_t<T, 2>(x, g, part, dw, nblocks, n, h, wd, c, s);
    case 3: return dw_t<T, 3>(x, g, part, dw, nblocks, n, h, wd, c, s);
    case 4: return dw_t<T, 4>(x, g, part, dw, nblocks, n, h, wd, c, s);
    case 5: return dw_t<T, 5>(x, g, part, dw, nblocks, n, h, wd, c, s);
    case 6: return dw_t<T, 6>(x, g, part, dw, nblocks, n, h, wd, c, s);
    case 7: return dw_t<T, 7>(x, g, part, dw, nblocks, n, h, wd, c, s);
    case 8: return dw_t<T, 8>(x, g, part, dw, nblocks, n, h, wd, c, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_f(const void* x, const void* w, void* y, int n, int h,
                     int wd, int c, int f, cudaStream_t s) {
  switch (f) {
    case 1: return fwd_t<T, 1>(x, w, y, n, h, wd, c, s);
    case 2: return fwd_t<T, 2>(x, w, y, n, h, wd, c, s);
    case 3: return fwd_t<T, 3>(x, w, y, n, h, wd, c, s);
    case 4: return fwd_t<T, 4>(x, w, y, n, h, wd, c, s);
    case 5: return fwd_t<T, 5>(x, w, y, n, h, wd, c, s);
    case 6: return fwd_t<T, 6>(x, w, y, n, h, wd, c, s);
    case 7: return fwd_t<T, 7>(x, w, y, n, h, wd, c, s);
    case 8: return fwd_t<T, 8>(x, w, y, n, h, wd, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

DEFINE_ERROR_STRING(conv_thin)

// x (n,h,wd,c) and y (n,h,wd,f) in `dtype`, w (3,3,c,f) in `dtype`; all
// contiguous, c a multiple of 8 and x 16-byte aligned (its rows are bulk
// copies).  Returns cudaGetLastError() after the launch.
extern "C" int conv_thin_launch(const void* x, const void* w, void* y, int n,
                                int h, int wd, int c, int f, int dtype,
                                void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c > 64 || c % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_f<float>(x, w, y, n, h, wd, c, f, s);
  if (dtype == kBF16)
    return launch_f<__nv_bfloat16>(x, w, y, n, h, wd, c, f, s);
  return cudaErrorInvalidValue;
}

// g (n,h,wd,f) and dx (n,h,wd,c) in `dtype`, w (3,3,c,f) in `dtype`; c a
// multiple of 8 and dx 16-byte aligned.
extern "C" int conv_thin_dx_launch(const void* g, const void* w, void* dx,
                                   int n, int h, int wd, int c, int f,
                                   int dtype, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c > 64 || c % 8 != 0 ||
      f <= 0 || f > 8 || reinterpret_cast<uintptr_t>(dx) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_dx<float>(g, w, dx, n, h, wd, c, f, s);
  if (dtype == kBF16)
    return launch_dx<__nv_bfloat16>(g, w, dx, n, h, wd, c, f, s);
  return cudaErrorInvalidValue;
}

// x (n,h,wd,c) and g (n,h,wd,f) in `dtype`, c a multiple of 8 and x
// 16-byte aligned; part: fp32 scratch of nblocks*9*c*f (two blocks an SM
// is the design); dw: fp32 (3,3,c,f).
extern "C" int conv_thin_dw_launch(const void* x, const void* g, void* part,
                                   void* dw, int nblocks, int n, int h,
                                   int wd, int c, int f, int dtype,
                                   void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c > 64 || c % 8 != 0 ||
      f <= 0 || f > 8 || nblocks <= 0 || reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_dw<float>(x, g, part, dw, nblocks, n, h, wd, c, f, s);
  if (dtype == kBF16)
    return launch_dw<__nv_bfloat16>(x, g, part, dw, nblocks, n, h, wd, c, f, s);
  return cudaErrorInvalidValue;
}
