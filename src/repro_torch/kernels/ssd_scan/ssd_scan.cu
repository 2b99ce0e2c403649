// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas
// (body `_kernel`, wrapper `ops.ssd_scan`).  Per sequence z (one batch row
// and head) with scalar decay rate a < 0 it runs the recurrence
//     h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T      (h: N x P)
//     y_t = C_t^T h_t
// in its chunked (state-space duality) form: within a chunk of L steps,
//     y = ((C B^T) o M)(X o dt) + exp(cum) o (C h_start),
//     M[t][s] = exp(cum_t - cum_s) [t >= s],  cum = cumsum(a dt),
//     h_end = exp(cum_L) h_start + (B o dt exp(cum_L - cum))^T X,
// and returns y (BH, T, P) and the final state (BH, N, P), all float32.
//
// What bounds it: operations.  Per chunk it needs about L^2 (N + P) / 2 +
// 2 L N P multiply-adds on (2 N + P + 1) L inputs and L P outputs, ~40
// FLOPs per byte at L = N = 128, P = 64, above the card's ~20 (IEEE f32 on
// CUDA cores; no TF32, no tensor cores).
//
// Design.  The TPU kernel walks the chunks of a sequence on its sequential
// grid axis with the N x P state in VMEM.  Only that state has to be
// sequential: each chunk's intra-chunk term and its own contribution to the
// state do not depend on earlier chunks (the batched form of
// `ssd_scan_chunked_jnp`).  So the scan is three kernels on one stream:
//   1. ssd_chunk_state: one block per (sequence, chunk).  Scans cum over
//      the chunk in float64 and stores it (scratch `cum`, BH x T float64)
//      so that kernels 2 and 3 read the same values; computes the chunk's
//      own state contribution h_in = (B o w)^T X (N x P over the chunk's
//      rows, 128 threads with an 8 x 8 register tile each, X scaled by w
//      once in shared memory, B and X streamed through two cp.async stages
//      of 32 rows) into scratch `state` (BH, NC, N, P).
//   2. ssd_state_pass: blocks over (sequence, 1024 state entries); each
//      thread walks the chunks in order, h_start[c] = h, h = exp(total_c) h
//      + h_in[c], writing h_start over h_in in place and the last h to
//      `hout`.  Bound by bytes (the state scratch is read and written once).
//   3. ssd_chunk_scan: one block per (sequence, chunk, 64-row half).  One
//      product C_half [B^T | h_start] over N gives the scores (only the
//      columns s < 64 (half + 1): the tile above the diagonal is never
//      computed) and C h_start together, 4 x 12 (or 4 x 8) register tile
//      per thread, float4 shared loads, the N dimension in slices of 32
//      double-buffered with cp.async.  The diagonal tile is masked before
//      exp, as `where(mask, seg, 0)` does (exp(cum_t - cum_s) for s > t
//      overflows, and inf * 0 is NaN).  Then y = exp(cum) C h_start + M X
//      over s <= t, 4 x 4 register tile per thread.
// Why cum is float64: under strong decay (a dt ~ -4 a step) cum reaches
// ~ -500 within a chunk, where a float32 ulp is 6e-5, and the difference
// cum_t - cum_s of two rounded values puts that error into every decay
// factor, ~5e-3 on outputs of magnitude ~100.  Differences of float64
// values, rounded once to float32, carry none of it; the float32 products
// stay as they are.
// Chunk state takes 128 threads and 51 KB of shared memory (four blocks,
// 16 warps, on an SM); state pass and chunk scan 256 threads, chunk scan
// 72 KB (two blocks, 16 warps).  Rows past the chunk, and past the end of the
// sequence, read as zeros: x = dt = B = C = 0 is the JAX wrapper's inert
// padding (decay 1, no state update, y not written).  One flattened 1-D
// grid per kernel, offsets in int64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 128;        // rows of the chunk tile (largest chunk)
constexpr int kHalf = 64;      // rows of kernel 3's block
constexpr int kNM = 128;       // largest state size N
constexpr int kPM = 64;        // largest head dim P
constexpr int kThreads = 256;       // kernels 2 and 3
constexpr int kStateThreads = 128;  // kernel 1: 16 n-groups x 8 p-groups
constexpr int kKS = 32;        // kernel 3: state columns per slice of C, B
constexpr int kKSP = kKS + 4;  // row stride of the C and B slices
constexpr int kMS = kL + 4;    // row stride of the masked scores M
constexpr int kStateTile = 4 * kThreads;  // kernel 2: entries per block
constexpr int kSR = 32;        // kernel 1: chunk rows per stage

constexpr int kStateStages = 2;  // kernel 1 pipeline depth
constexpr int kScanStages = 2;   // kernel 3 pipeline depth

// kernel 1: cum (float64), two stages of B (kSR x kNM) and X (kSR x kPM)
// rows, dt, w
constexpr int kStateStage = kSR * (kNM + kPM);
constexpr int kStateSmemBytes =
    8 * kL + 4 * (kStateStages * kStateStage + 2 * kL);
// kernel 3: two stages of C (kHalf x kKSP), B (kL x kKSP) and h_start
// (kKS x kPM) slices; after the product, M (kHalf x kMS) and X (kL x kPM)
// reuse them; then cum (float64) and dt
constexpr int kStageFloats = kHalf * kKSP + kL * kKSP + kKS * kPM;
constexpr int kScanSmemBytes =
    4 * kScanStages * kStageFloats + 8 * kL + 4 * kL;
static_assert(kHalf * kMS <= kStageFloats, "M must fit in one stage");
static_assert(kL * kPM <= kStageFloats, "X must fit in one stage");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Asynchronous copy of a rows x width tile (width a multiple of 4) from
// global memory (row stride gstride floats, from g) into shared memory
// (row stride sstride, from s).  Entries at rows >= valid_rows or columns
// >= valid_cols are zero-filled and read nothing (`base`, the start of the
// array, stands in as their address).  `vec`: 16-byte copies, which needs
// gstride and valid_cols to be multiples of 4.
template <int kT = kThreads>
__device__ __forceinline__ void load_tile(float* s, int sstride,
                                          const float* g, int64_t gstride,
                                          const float* base, int rows,
                                          int width, int valid_rows,
                                          int valid_cols, bool vec) {
  if (vec) {
    const int q = width / 4;
    for (int i = threadIdx.x; i < rows * q; i += kT) {
      const int r = i / q, col = 4 * (i - r * q);
      const bool ok = r < valid_rows && col < valid_cols;
      cp_async16(s + r * sstride + col, ok ? g + r * gstride + col : base, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += kT) {
      const int r = i / width, col = i - r * width;
      const bool ok = r < valid_rows && col < valid_cols;
      cp_async4(s + r * sstride + col, ok ? g + r * gstride + col : base, ok);
    }
  }
}

// Inclusive cumsum of a dt over the kL rows of `dts` into `cum`, in
// float64, by warp 0: 4 rows per lane, then a warp scan.  Rows past the
// chunk hold dt = 0, so they carry the chunk's total.
__device__ __forceinline__ void chunk_cumsum(const float* dts, double* cum,
                                             float az) {
  const int lane = threadIdx.x;
  double v[4], run = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += (double)az * dts[4 * lane + k];
    v[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) cum[4 * lane + k] = incl - run + v[k];
}

// 1. Per (sequence, chunk): cum into `cumg`, h_in = (B o w)^T X into
//    `state`, w = dt exp(total - cum).  B and X stream through two stages
//    of kSR rows.
__global__ void __launch_bounds__(kStateThreads, 4)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                double* __restrict__ cumg, float* __restrict__ state, int t,
                int p, int n, int ch, int nc, int vec) {
  extern __shared__ __align__(16) float smem[];
  double* cum = reinterpret_cast<double*>(smem);  // [kL]
  float* stages = smem + 2 * kL;  // 2 x (B [kSR][kNM], X [kSR][kPM])
  float* dts = stages + kStateStages * kStateStage;  // [kL]
  float* wv = dts + kL;                           // [kL]

  const int64_t blk = blockIdx.x;
  const int64_t z = blk / nc;
  const int c = static_cast<int>(blk - z * nc);
  const int t0 = c * ch;
  const int len = min(ch, t - t0);
  const int64_t row0 = z * t + t0;  // first time step of the chunk
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int n_slices = (len + kSR - 1) / kSR;

  auto load_rows = [&](int k) {
    float* buf = stages + (k % kStateStages) * kStateStage;
    const int r = k * kSR, rows = min(kSR, len - r);
    load_tile<kStateThreads>(buf, kNM, bm + (row0 + r) * n, n, bm, rows,
                             kNM, rows, n, vec);
    load_tile<kStateThreads>(buf + kSR * kNM, kPM, x + (row0 + r) * p, p, x,
                             rows, kPM, rows, p, vec);
  };
  for (int k = 0; k < kStateStages - 1; ++k) {
    if (k < n_slices) load_rows(k);
    cp_async_commit();
  }

  if (tid < kL) dts[tid] = tid < len ? dt[row0 + tid] : 0.f;
  __syncthreads();
  if (tid < 32) chunk_cumsum(dts, cum, a[z]);
  __syncthreads();
  const double total = cum[kL - 1];
  if (tid < kL) {
    wv[tid] = dts[tid] * expf(static_cast<float>(total - cum[tid]));
    if (tid < len) cumg[row0 + tid] = cum[tid];
  }

  // state rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and
  // 32 + 4 tx + j (i, j < 4): a quarter-warp reads one float4 of B
  // (broadcast) and 128 contiguous bytes of X per float4 load
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < n_slices; ++k) {
    if (k + kStateStages - 1 < n_slices) load_rows(k + kStateStages - 1);
    cp_async_commit();
    cp_async_wait<kStateStages - 1>();
    __syncthreads();
    const float* bs = stages + (k % kStateStages) * kStateStage;
    float* xs = stages + (k % kStateStages) * kStateStage + kSR * kNM;
    const int rows = min(kSR, len - k * kSR);
    for (int e = tid; e < rows * kPM; e += kStateThreads)  // X o w, once
      xs[e] *= wv[k * kSR + e / kPM];
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < rows; ++s) {
      const float4 b0 = *reinterpret_cast<const float4*>(bs + s * kNM + 4 * ty);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + s * kNM + 64 + 4 * ty);
      const float4 x0 = *reinterpret_cast<const float4*>(xs + s * kPM + 4 * tx);
      const float4 x1 =
          *reinterpret_cast<const float4*>(xs + s * kPM + 32 + 4 * tx);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = state + (z * nc + c) * n * p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64 - 4) + 4 * ty + i;
    if (r >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 32 * h + 4 * tx;
      if (vec) {
        if (col < p)
          *reinterpret_cast<float4*>(out + r * p + col) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < p) out[r * p + col + j] = acc[i][4 * h + j];
      }
    }
  }
}

// 2. Per (sequence, tile of kStateTile state entries): the carry over
//    chunks.  state[z][c] holds h_in on entry and h_start on exit.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(const double* __restrict__ cumg, float* __restrict__ state,
               float* __restrict__ hout, int t, int np, int ch, int nc,
               int tiles) {
  const int64_t blk = blockIdx.x;
  const int64_t z = blk / tiles;
  const int tile = static_cast<int>(blk - z * tiles);
  int idx[4];
  bool ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    idx[e] = tile * kStateTile + e * kThreads + threadIdx.x;
    ok[e] = idx[e] < np;
  }
  float* st = state + z * nc * np;
  const double* cz = cumg + z * t;
  float h[4] = {0.f, 0.f, 0.f, 0.f}, nxt[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) nxt[e] = ok[e] ? st[idx[e]] : 0.f;
  for (int c = 0; c < nc; ++c) {
    float cur[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) cur[e] = nxt[e];
    if (c + 1 < nc) {  // the next chunk's loads go out before this one's
#pragma unroll
      for (int e = 0; e < 4; ++e)
        nxt[e] = ok[e] ? st[(int64_t)(c + 1) * np + idx[e]] : 0.f;
    }
    const float decay = expf(static_cast<float>(cz[min((c + 1) * ch, t) - 1]));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ok[e]) st[(int64_t)c * np + idx[e]] = h[e];
      h[e] = fmaf(decay, h[e], cur[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (ok[e]) hout[z * np + idx[e]] = h[e];
}

// Kernel 3's product and epilogue for a block with kNJ x 16 score
// columns (kNJ = 4 on the first half, 8 on the second).
template <int kNJ>
__device__ __forceinline__ void chunk_scan_block(
    const float* __restrict__ x, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ hstart,
    float* __restrict__ y, float* smem, const double* cum, const float* dts,
    int64_t row0, int r0, int len, int p, int n, int vec) {
  constexpr int kCols = 16 * kNJ;  // score columns: chunk rows 0 .. kCols-1
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  auto stage = [smem](int k) {
    return smem + (k % kScanStages) * kStageFloats;
  };
  const int n_slices = (n + kKS - 1) / kKS;

  auto load_slice = [&](int k, float* buf) {
    const int n0 = k * kKS, vn = min(kKS, n - n0);
    load_tile(buf, kKSP, cm + (row0 + r0) * n + n0, n, cm, kHalf, kKS,
              len - r0, vn, vec);
    load_tile(buf + kHalf * kKSP, kKSP, bm + row0 * n + n0, n, bm, kCols,
              kKS, len, vn, vec);
    load_tile(buf + kHalf * kKSP + kL * kKSP, kPM, hstart + n0 * p, p,
              hstart, kKS, kPM, vn, p, vec);
  };

  // rows r0 + 4 ty + i; score columns tx + 16 j; y columns 4 tx + q
  float sacc[4][kNJ], yacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) sacc[i][j] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) yacc[i][q] = 0.f;
  }

  // slice j goes to stage j; the free stage after the last slice takes X
  // for the epilogue
  auto issue = [&](int j) {
    if (j < n_slices)
      load_slice(j, stage(j));
    else if (j == n_slices)
      load_tile(stage(j), kPM, x + row0 * p, p, x, kCols, kPM, len, p, vec);
    cp_async_commit();
  };
  for (int j = 0; j < kScanStages - 1; ++j) issue(j);
  for (int k = 0; k < n_slices; ++k) {
    issue(k + kScanStages - 1);
    cp_async_wait<kScanStages - 1>();
    __syncthreads();
    const float* cs = stage(k);
    const float* bs = cs + kHalf * kKSP;
    const float* hs = bs + kL * kKSP;
#pragma unroll 1
    for (int kq = 0; kq < kKS; kq += 4) {
      float cv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(cs + (4 * ty + i) * kKSP + kq);
        cv[i][0] = v.x; cv[i][1] = v.y; cv[i][2] = v.z; cv[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kKSP + kq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = sacc[i][j];
          s = fmaf(cv[i][0], b.x, s);
          s = fmaf(cv[i][1], b.y, s);
          s = fmaf(cv[i][2], b.z, s);
          sacc[i][j] = fmaf(cv[i][3], b.w, s);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 hv =
            *reinterpret_cast<const float4*>(hs + (kq + kk) * kPM + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yacc[i][0] = fmaf(cv[i][kk], hv.x, yacc[i][0]);
          yacc[i][1] = fmaf(cv[i][kk], hv.y, yacc[i][1]);
          yacc[i][2] = fmaf(cv[i][kk], hv.z, yacc[i][2]);
          yacc[i][3] = fmaf(cv[i][kk], hv.w, yacc[i][3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // M = (C B^T) o exp(cum_t - cum_s) [t >= s] o dt_s into the stage of the
  // last slice (every thread is past it); y so far = exp(cum_t) C h_start
  float* ms = stage(n_slices - 1);
  const float* xs = stage(n_slices);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tr = r0 + 4 * ty + i;
    const double ct = cum[tr];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int sc = tx + 16 * j;
      const bool keep = sc <= tr;
      // masked before exp; the difference taken in float64
      const float seg = keep ? static_cast<float>(ct - cum[sc]) : 0.f;
      ms[(4 * ty + i) * kMS + sc] = keep ? sacc[i][j] * expf(seg) * dts[sc]
                                         : 0.f;
    }
    const float e = expf(static_cast<float>(ct));
#pragma unroll
    for (int q = 0; q < 4; ++q) yacc[i][q] *= e;
  }
  __syncthreads();

  // y += M X over s <= t: a warp's rows end at r0 + 8 w + 7
  const int s_end = r0 + 8 * (tid >> 5) + 8;
#pragma unroll 2
  for (int s0 = 0; s0 < s_end; s0 += 4) {
    float mv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(ms + (4 * ty + i) * kMS + s0);
      mv[i][0] = v.x; mv[i][1] = v.y; mv[i][2] = v.z; mv[i][3] = v.w;
    }
#pragma unroll
    for (int ss = 0; ss < 4; ++ss) {
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + (s0 + ss) * kPM + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yacc[i][0] = fmaf(mv[i][ss], xv.x, yacc[i][0]);
        yacc[i][1] = fmaf(mv[i][ss], xv.y, yacc[i][1]);
        yacc[i][2] = fmaf(mv[i][ss], xv.z, yacc[i][2]);
        yacc[i][3] = fmaf(mv[i][ss], xv.w, yacc[i][3]);
      }
    }
  }

  const int col = 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= len) break;
    float* out = y + (row0 + r) * p;
    if (vec) {
      if (col < p)
        *reinterpret_cast<float4*>(out + col) =
            make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < p) out[col + q] = yacc[i][q];
    }
  }
}

// 3. Per (sequence, chunk, 64-row half): y of those rows.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const double* __restrict__ cumg,
               const float* __restrict__ state, float* __restrict__ y,
               int t, int p, int n, int ch, int nc, int halves, int vec) {
  extern __shared__ __align__(16) float smem[];
  double* cum =
      reinterpret_cast<double*>(smem + kScanStages * kStageFloats);  // [kL]
  float* dts = reinterpret_cast<float*>(cum + kL);                    // [kL]

  const int64_t blk = blockIdx.x;
  const int64_t zc = blk / halves;
  const int half = static_cast<int>(blk - zc * halves);
  const int64_t z = zc / nc;
  const int c = static_cast<int>(zc - z * nc);
  const int t0 = c * ch;
  const int len = min(ch, t - t0);
  const int r0 = half * kHalf;
  if (r0 >= len) return;  // the whole block: no row of this half exists
  const int64_t row0 = z * t + t0;

  // cum as kernel 1 stored it; rows past the chunk carry its total
  const int tid = threadIdx.x;
  if (tid < kL) {
    cum[tid] = cumg[row0 + min(tid, len - 1)];
    dts[tid] = tid < len ? dt[row0 + tid] : 0.f;
  }
  // visible to all after the first __syncthreads of the product loop
  const float* hstart = state + (z * nc + c) * n * p;
  if (half == 0)
    chunk_scan_block<4>(x, bm, cm, hstart, y, smem, cum, dts, row0, r0, len,
                        p, n, vec);
  else
    chunk_scan_block<8>(x, bm, cm, hstart, y, smem, cum, dts, row0, r0, len,
                        p, n, vec);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// x (bh, t, p), dt (bh, t), a (bh), b and c (bh, t, n), all float32 and
// contiguous; y (bh, t, p) and h (bh, n, p) are written.  Scratch, written
// and read here: cum (bh, t) float64 and state (bh, ceil(t / chunk), n,
// p) float32.  1 <= p <= 64, 1 <= n <= 128, 1 <= chunk <= 128, t >= 1.
// Launches the three kernels on `stream`; returns a cudaError_t code (0 on
// success).
extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* a, const float* b,
                               const float* c, float* y, float* h,
                               double* cum, float* state, int bh, int t,
                               int p, int n, int chunk, void* stream) {
  if (p < 1 || p > kPM || n < 1 || n > kNM || chunk < 1 || chunk > kL ||
      t < 1 || bh < 1)
    return cudaErrorInvalidValue;
  const int nc = (t + chunk - 1) / chunk;
  const int halves = (chunk + kHalf - 1) / kHalf;
  const int tiles = (n * p + kStateTile - 1) / kStateTile;
  const int64_t blocks_state = (int64_t)bh * nc;
  const int64_t blocks_pass = (int64_t)bh * tiles;
  const int64_t blocks_scan = blocks_state * halves;
  if (blocks_scan > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int vec = n % 4 == 0 && p % 4 == 0;
  const int smem_state = kStateSmemBytes, smem_scan = kScanSmemBytes;
  cudaError_t err = set_smem(ssd_chunk_state, smem_state);
  if (err == cudaSuccess) err = set_smem(ssd_chunk_scan, smem_scan);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_chunk_state<<<(unsigned)blocks_state, kStateThreads, smem_state, s>>>(
      x, dt, a, b, cum, state, t, p, n, chunk, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass<<<(unsigned)blocks_pass, kThreads, 0, s>>>(
      cum, state, h, t, n * p, chunk, nc, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan<<<(unsigned)blocks_scan, kThreads, smem_scan, s>>>(
      x, dt, b, c, cum, state, y, t, p, n, chunk, nc, halves, vec);
  return cudaGetLastError();
}

// The kernels' own launch constants, for the wrapper's mirror of them:
// out = {kernel-1 threads, kernel-2 and -3 threads, rows per kernel-3
// block, state entries per kernel-2 block, kernel-1 shared bytes, kernel-3
// shared bytes}.
extern "C" int ssd_scan_geometry(int* out) {
  out[0] = kStateThreads;
  out[1] = kThreads;
  out[2] = kHalf;
  out[3] = kStateTile;
  out[4] = kStateSmemBytes;
  out[5] = kScanSmemBytes;
  return 0;
}

extern "C" const char* ssd_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
