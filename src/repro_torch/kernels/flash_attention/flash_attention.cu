// Causal (or full) GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body `_kernel`, wrapper `ops.flash_attention`).  For q (B*Hq, Sq, D) and
// k, v (B*Hkv, Sk, D) it computes softmax(q k^T * scale + mask) v per head
// with an online softmax, never holding the (Sq, Sk) scores.  Queries are
// aligned to the end of the keys: query i sees keys <= i + Sk - Sq when
// causal.  The kv head of q head h is h / (Hq / Hkv), read through the
// index; K and V are never repeated in memory.
//
// What bounds it: operations.  2 * Sq * Sk * D multiply-adds per head
// (halved by the causal mask) against (Sq + 2 Sk) * D elements moved, so
// at D = 128 and Sk = 4096 it does ~2000 FLOPs per byte, far above the
// card's ~20 (f32 CUDA cores) or ~300 (bf16 tensor cores) FLOPs per byte.
//
// Design (a first, simple kernel: CUDA cores, float32 arithmetic for both
// input types; no wgmma or TMA yet).  One block of 128 threads owns one
// (batch*head, 64-query tile); the TPU's sequential kv grid axis becomes a
// loop inside the block over 64-key tiles.  The Q tile and each K tile sit
// in shared memory transposed ([d][row], row stride 65 so both the
// transposing stores and the reads are free of bank conflicts), V as
// [key][d].  Each thread computes a 4 x 8 block of the 64 x 64 scores
// (rows 4*ty + i, keys tx + 8*j), keeps the running max and sum of its 4
// rows in registers (the 8 lanes of a row agree through __shfl_xor), and
// accumulates a 4 x D/8 block of the output in registers.  P goes through
// shared memory (over the K tile, which is no longer needed) for the P*V
// product.  Keys >= Sk and keys above the causal diagonal are masked with
// -inf inside the kernel, and key tiles wholly above the diagonal are not
// visited (the Pallas `run` predicate), so the caller passes the true Sq
// and Sk and no padded copy.  Query tiles are issued heaviest first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // queries per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 128;     // 16 row groups (ty) x 8 lanes (tx)
constexpr int kPad = kBK + 1;     // row stride of the transposed tiles and P

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

template <int D>
constexpr int smem_floats() {
  // qt [D][kPad] + kt/P [max(D, kBQ)][kPad] + vs [kBK][D]
  return D * kPad + (D > kBQ ? D : kBQ) * kPad + kBK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
          int sq, int sk, float scale, int causal) {
  constexpr int DC = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                   // [D][kPad]  scaled Q tile, transposed
  float* kt = qt + D * kPad;          // [D][kPad]  K tile, transposed
  float* ps = kt;                     // [kBQ][kPad] P, over the K tile
  float* vs = kt + (D > kBQ ? D : kBQ) * kPad;  // [kBK][D]

  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int kvh = b * hkv + (bh - b * hq) / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int q_offset = sk - sq;
  const T* qb = q + (int64_t)bh * sq * D;
  const T* kb = k + (int64_t)kvh * sk * D;
  const T* vb = v + (int64_t)kvh * sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qt[d * kPad + r] =
        q0 + r < sq ? to_f32(qb[(int64_t)(q0 + r) * D + d]) * scale : 0.f;
  }

  // keys [0, k_end) are visible to some row of this tile
  const int k_end = causal ? min(sk, q_offset + q0 + kBQ) : sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's P*V is done with ps and vs
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const bool in = k0 + c < sk;
      const int64_t off = (int64_t)(k0 + c) * D + d;
      kt[d * kPad + c] = in ? to_f32(kb[off]) : 0.f;
      vs[c * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[d * kPad + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = kt[d * kPad + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool ok = kpos < sk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - shift);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - shift);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done reading kt
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ps[(ty * 4 + i) * kPad + tx + 8 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kPad + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[c * D + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + ((int64_t)bh * sq + r) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) store(orow + tx + 8 * j, acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int sq, int sk, int causal,
                   float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int b, int hq, int hkv, int sq, int sk, int d,
                     int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, sk, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, sk, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b*hq, sq, d), k and v (b*hkv, sk, d), o like q; all contiguous, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1).  d is 16, 32, 64 or 128;
// hq is a multiple of hkv; sq >= 1, sk >= 1, and sq <= sk when causal.
// Returns a cudaError_t code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int sq, int sk, int d,
                                      int causal, float scale, int bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d, causal,
                                   scale, s);
  return launch_d<float>(q, k, v, o, b, hq, hkv, sq, sk, d, causal, scale, s);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
