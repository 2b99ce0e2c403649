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
// What bounds it: operations.  Per chunk it does about L^2 (N + P) / 2 +
// 2 L N P multiply-adds on (2 N + P + 1) L inputs and L P outputs, ~40
// FLOPs per byte at L = N = 128, P = 64, above the card's ~20 (f32 CUDA
// cores).
//
// Design (a first, simple kernel on CUDA cores).  The TPU kernel walks the
// chunks of a sequence on its sequential grid axis with the N x P state in
// VMEM.  Here one block of 256 threads owns one sequence and walks its
// chunks in a loop, with the state in shared memory for the whole
// sequence.  Shared memory holds the state (N x P), the chunk's X (L x P),
// the decay-masked scores (L x L) and one 32-wide slice of C and of B at a
// time (transposed, row stride L + 1, free of bank conflicts): at the
// main path's L = N = 128, P = 64 the whole C and B tiles (64 KiB each)
// would not fit beside the rest, so the scores C B^T, the inter-chunk
// term C h_start and the state update are each accumulated over N in
// slices of 32.  Each thread holds an 8 x 8 block of the scores (rows
// 8*ty + i, columns tx + 16*j) and an 8 x 4 block of y in registers.  The
// slice loop reads the old state rows of a slice for C h_start before it
// overwrites them with the new state, so one state buffer serves both.
// A chunk is a fixed 128-row tile whose rows past the chunk length, and
// past the end of the sequence, read as zeros: x = dt = B = C = 0 is the
// JAX wrapper's inert padding (decay 1, no state update, y not written).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 128;        // rows of the chunk tile (largest chunk)
constexpr int kNS = 32;        // state rows per slice of C and B
constexpr int kNM = 128;       // largest state size N
constexpr int kPM = 64;        // largest head dim P
constexpr int kThreads = 256;  // 16 row groups (ty) x 16 lanes (tx)
constexpr int kLP = kL + 1;    // row stride of the transposed slices and M

constexpr int kSmemFloats =
    kL * kPM + kNM * kPM + 2 * kNS * kLP + kL * kLP + 4 * kL;

__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, float* __restrict__ y,
               float* __restrict__ hout, int t, int p, int n, int ch) {
  extern __shared__ float smem[];
  float* xs = smem;                // [kL][kPM]  X of the chunk
  float* hs = xs + kL * kPM;       // [kNM][kPM] state
  float* ct = hs + kNM * kPM;      // [kNS][kLP] C slice, transposed
  float* bt = ct + kNS * kLP;      // [kNS][kLP] B slice, transposed
  float* ms = bt + kNS * kLP;      // [kL][kLP]  (C B^T) o M o dt_s
  float* dts = ms + kL * kLP;      // [kL] dt
  float* cum = dts + kL;           // [kL] inclusive cumsum of a dt
  float* ecum = cum + kL;          // [kL] exp(cum)
  float* wv = ecum + kL;           // [kL] dt exp(cum_L - cum)

  const int z = blockIdx.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float az = a[z];
  const int64_t row0 = (int64_t)z * t;  // first time step of sequence z

  for (int i = tid; i < kNM * kPM; i += kThreads) hs[i] = 0.f;

  const int n_chunks = (t + ch - 1) / ch;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * ch;
    const int len = min(ch, t - t0);
    __syncthreads();  // the last chunk is done with xs, ms and dts
    for (int i = tid; i < kL * kPM; i += kThreads) {
      const int r = i / kPM, col = i - r * kPM;
      xs[i] = r < len && col < p ? x[(row0 + t0 + r) * p + col] : 0.f;
    }
    for (int r = tid; r < kL; r += kThreads)
      dts[r] = r < len ? dt[row0 + t0 + r] : 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum of a dt: 4 rows per lane, then a warp scan
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += az * dts[4 * tid + k];
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) cum[4 * tid + k] = incl - run + v[k];
    }
    __syncthreads();
    const float total = cum[kL - 1];
    const float etot = expf(total);
    for (int r = tid; r < kL; r += kThreads) {
      ecum[r] = expf(cum[r]);
      wv[r] = dts[r] * expf(total - cum[r]);
    }

    float sacc[8][8], yacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
    }

    for (int n0 = 0; n0 < n; n0 += kNS) {
      __syncthreads();  // the last slice's state update is done with bt
      for (int i = tid; i < kNS * kL; i += kThreads) {
        const int r = i / kNS, nn = i - r * kNS;
        const bool in = r < len && n0 + nn < n;
        const int64_t off = (row0 + t0 + r) * n + n0 + nn;
        ct[nn * kLP + r] = in ? cm[off] : 0.f;
        bt[nn * kLP + r] = in ? bm[off] : 0.f;
      }
      __syncthreads();
      // scores += C B^T and yacc += C h_start over this slice
#pragma unroll 2
      for (int nn = 0; nn < kNS; ++nn) {
        float cv[8], bv[8], hv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = ct[nn * kLP + ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bt[nn * kLP + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hs[(n0 + nn) * kPM + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) sacc[i][j] = fmaf(cv[i], bv[j], sacc[i][j]);
#pragma unroll
          for (int j = 0; j < 4; ++j) yacc[i][j] = fmaf(cv[i], hv[j], yacc[i][j]);
        }
      }
      __syncthreads();  // every thread has read the old state rows
      // state rows n0 + 2*(tid/16) + {0, 1}: exp(total) h + (B o w)^T X
      float hn[2][4];
      const int nr = 2 * ty;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hn[i][j] = etot * hs[(n0 + nr + i) * kPM + tx + 16 * j];
#pragma unroll 4
      for (int s = 0; s < kL; ++s) {
        const float w = wv[s];
        float bw[2], xv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) bw[i] = bt[(nr + i) * kLP + s] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[s * kPM + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) hn[i][j] = fmaf(bw[i], xv[j], hn[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hs[(n0 + nr + i) * kPM + tx + 16 * j] = hn[i][j];
    }

    // M = (C B^T) o exp(cum_t - cum_s) [t >= s] o dt_s; y = exp(cum) C h
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int tr = ty * 8 + i;
      const float ct_ = cum[tr];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int sc = tx + 16 * j;
        ms[tr * kLP + sc] =
            sc <= tr ? sacc[i][j] * expf(ct_ - cum[sc]) * dts[sc] : 0.f;
      }
      const float e = ecum[tr];
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] *= e;
    }
    __syncthreads();
    // y += M X over s <= t
    const int s_end = ty * 8 + 8;
    for (int s = 0; s < s_end; ++s) {
      float mv[8], xv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) mv[i] = ms[(ty * 8 + i) * kLP + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[s * kPM + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] = fmaf(mv[i], xv[j], yacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      if (r >= len) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        if (col < p) y[(row0 + t0 + r) * p + col] = yacc[i][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n * p; i += kThreads) {
    const int nn = i / p, col = i - nn * p;
    hout[(int64_t)z * n * p + i] = hs[nn * kPM + col];
  }
}

}  // namespace

// x (bh, t, p), dt (bh, t), a (bh), b and c (bh, t, n), all float32 and
// contiguous; y (bh, t, p) and h (bh, n, p) are written.  1 <= p <= 64,
// 1 <= n <= 128, 1 <= chunk <= 128, t >= 1.  Returns a cudaError_t code
// (0 on success).
extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* a, const float* b,
                               const float* c, float* y, float* h, int bh,
                               int t, int p, int n, int chunk, void* stream) {
  if (p < 1 || p > kPM || n < 1 || n > kNM || chunk < 1 || chunk > kL ||
      t < 1 || bh < 1)
    return cudaErrorInvalidValue;
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<<<bh, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, a, b, c, y, h, t, p, n, chunk);
  return cudaGetLastError();
}

extern "C" const char* ssd_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
