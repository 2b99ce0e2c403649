// Causal (or full) GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body `_kernel`, wrapper `ops.flash_attention`).  For q (B*Hq, Sq, D) and
// k, v (B*Hkv, Sk, D) it computes softmax(q k^T * scale + mask) v per head
// with an online softmax, never holding the (Sq, Sk) scores.  Queries are
// aligned to the end of the keys: query i sees keys <= i + Sk - Sq when
// causal.  The kv head of q head h is h / (Hq / Hkv), read through the
// index; K and V are never repeated in memory.  Keys >= Sk are masked in
// the kernel (no padded copy), key tiles wholly above the causal diagonal
// are not visited (the Pallas `run` predicate), and query tiles are issued
// heaviest first over one flattened grid of (query tile, batch*head).
//
// What bounds it: operations.  4 * D FLOPs per visible (query, key) pair
// against (2 Sq + 2 Sk) * D elements moved: at D = 128 and Sk = 4096 about
// 2000 FLOPs per byte, far above the card's ~20 (f32 CUDA cores) or ~300
// (bf16 tensor cores) FLOPs per byte.  So the design keeps the math units
// fed: tensor cores for bf16, register tiles for f32, copies overlapped.
//
// Two routes (the wrapper, cuda.py, picks one and mirrors the geometry):
//
// * wgmma (bf16, D = 64 or 128).  A block of 384 threads owns 128 queries:
//   two consumer warpgroups of 64 query rows each and one producer
//   warpgroup, which gives its registers to the consumers (setmaxnreg 24 /
//   240).  One producer thread loads Q once and streams 128-key K and V
//   tiles with TMA (cp.async.bulk.tensor, 128-byte swizzle, 64-column
//   boxes) into a ring of 3 stages guarded by mbarriers (full: bytes
//   landed; empty: all 8 consumer warps are done with the slot), so tiles
//   t+1 and t+2 are in flight while tile t computes (with 2 stages the
//   consumers waited on the copies).  S = Q K^T is wgmma m64n128k16 with
//   both operands in shared memory (K-major); the f32 scores are masked
//   and soft-maxed in the accumulator registers (row max and sum across
//   the quad of a row, scores pre-scaled by scale*log2(e) for one
//   ex2.approx each), rounded in place to bf16 A fragments, and O += P V
//   is wgmma with P from registers and V from shared memory (MN-major,
//   the transpose bit).  On
//   unmasked tiles S of tile t is issued before P V of tile t-1, so the
//   softmax of tile t overlaps P V of tile t-1 on the tensor cores; the
//   masked tiles (the diagonal and the ragged last key tile, a suffix of
//   the loop) run one at a time and add the product of P's bf16 rounding
//   residual, so rows that see few keys keep f32 weights.  128-key tiles:
//   the S accumulator (64 regs), the P fragments (32) and the O
//   accumulator (D/2) fit the 240 registers a consumer thread holds, and
//   three stages of K and V (192 KB at D = 128) plus Q (32 KB) fit shared
//   memory, so n128 wgmmas halve the instruction count of 64-key tiles.
// * simt (f32, and bf16 at D = 16, 32 or 256: the 32- and 64-byte rows
//   of D = 16 and 32 do not fill the 128-byte swizzle, and the wgmma
//   route's ring of 128-key tiles does not fit shared memory at D = 256;
//   both dtypes in IEEE f32 on CUDA cores, no TF32).  A block of 256
//   threads owns 64 queries; each thread holds a 4 x 4 score tile and a
//   4 x D/16 output tile in registers, fed by 16-byte shared loads (8
//   FMAs per load in Q K^T) from tiles kept d-contiguous with a 16-byte
//   XOR swizzle (no padding, no bank conflicts), whose XOR the inner loops
//   take from compile-time and per-thread parts with no index arithmetic.
//   Q, K, V and P take 112 KB at D = 128, so two blocks (16 warps) fit an
//   SM; at D = 256 they take 208 KB, one block an SM, which may then use
//   up to 255 registers a thread for its 4 x 16 output tile.  K and V of
//   tile t+1 are copied with cp.async while tile t computes: K(t+1) during
//   the softmax and P V of tile t, V(t+1) during the Q K^T of tile t+1.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ------------------------------------------------------------------------
// simt route: f32 math on CUDA cores
// ------------------------------------------------------------------------
constexpr int kSBQ = 64;         // queries per block
constexpr int kSBK = 64;         // keys per tile
constexpr int kSThreads = 256;   // 16 row groups (ty) x 16 lanes (tx)

template <int D>
constexpr int simt_smem_bytes() {
  return (3 * kSBQ * D + kSBQ * kSBK) * (int)sizeof(float);
}

// blocks an SM holds at once, by shared memory (233,472 bytes an SM, of
// which the system reserves 1,024 a block): two up to D = 128, one at
// D = 256; the launch bound asks for as many
template <int D>
constexpr int simt_blocks_per_sm() {
  return 2 * (simt_smem_bytes<D>() + 1024) <= 233472 ? 2 : 1;
}

// [row][D] f32 tiles: the 16-byte chunk d/4 of row r is stored at chunk
// (d/4) ^ (r % 8) (or r % (D/4) when a row has fewer than 8 chunks)
template <int D>
__device__ __forceinline__ int sw(int r, int d) {
  constexpr int mask = (D / 4 < 8 ? D / 4 : 8) - 1;
  return r * D + ((((d >> 2) ^ (r & mask))) << 2) + (d & 3);
}

// [query][key] P tile: rows 4 apart (the two row groups of a warp) take
// opposite halves of the 128-byte line
__device__ __forceinline__ int psw(int r, int k) {
  return r * kSBK + (((k >> 2) ^ (((r >> 2) & 1) << 2)) << 2) + (k & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [row0, row0 + 64) of a (rows, D) matrix into a swizzled f32 tile;
// rows >= nrows are zero-filled.  f32 goes by cp.async (waited for by the
// caller); bf16 (D = 16, 32 and 256) is converted by plain loads.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int nrows, int tid) {
  constexpr int kChunks = kSBQ * D / 4;
#pragma unroll
  for (int i = tid; i < kChunks; i += kSThreads) {
    const int r = i / (D / 4), c = i - r * (D / 4);
    const bool valid = row0 + r < nrows;
    const float* g = src + (int64_t)(valid ? row0 + r : 0) * D + 4 * c;
    cp_async16(dst + sw<D>(r, 4 * c), g, valid);
  }
}
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, int tid) {
  constexpr int kChunks = kSBQ * D / 4;
#pragma unroll
  for (int i = tid; i < kChunks; i += kSThreads) {
    const int r = i / (D / 4), c = i - r * (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) {
      const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(
          src + (int64_t)(row0 + r) * D + 4 * c);
      const float2 a = __bfloat1622float2(g[0]), b = __bfloat1622float2(g[1]);
      x = make_float4(a.x, a.y, b.x, b.y);
    }
    *reinterpret_cast<float4*>(dst + sw<D>(r, 4 * c)) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kSThreads, simt_blocks_per_sm<D>())
flash_simt(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int bhq, int hq,
           int hkv, int sq, int sk, int n_qtiles, float scale_log2,
           int causal) {
  constexpr int VEC = D >= 64 ? 4 : 1;   // output columns per vector
  constexpr int NC = D / (16 * VEC);     // vectors per row and thread
  constexpr int DC = NC * VEC;           // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][D] swizzled
  float* ks = qs + kSBQ * D;                    // [64][D] swizzled
  float* vs = ks + kSBK * D;                    // [64][D] swizzled
  float* ps = vs + kSBK * D;                    // [64][64] psw

  const int tile = n_qtiles - 1 - (int)(blockIdx.x / bhq);  // heaviest first
  const int bh = (int)(blockIdx.x % bhq);
  const int b = bh / hq;
  const int kvh = b * hkv + (bh - b * hq) / (hq / hkv);
  const int q0 = tile * kSBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q_offset = sk - sq;
  // The swizzle sw() with its XOR split into compile-time and per-thread
  // parts, so the inner loops add no index arithmetic: for a row r with
  // m = r % 8 = 4 b + m3, chunk 4 it + u sits at 4 (it ^ b) + (u ^ m3).
  // This thread's Q rows 4 ty + i have b = ty % 2 and m3 = i; its K rows
  // tx + 16 j have b = (tx / 4) % 2 and m3 = tx % 4 (at D = 16 a row has
  // 4 chunks and b = 0).
  const float* q_at = qs + 4 * ty * D;
  const float* k_at = ks + tx * D;
  const int q_hi = D >= 32 ? ty & 1 : 0, k_hi = D >= 32 ? (tx >> 2) & 1 : 0;
  int k_lo[4], v_lo[8];
#pragma unroll
  for (int u = 0; u < 4; ++u) k_lo[u] = (u ^ (tx & 3)) << 2;
#pragma unroll
  for (int m = 0; m < 8; ++m) v_lo[m] = (tx ^ m) << 2;
  const T* qb = q + (int64_t)bh * sq * D;
  const T* kb = k + (int64_t)kvh * sk * D;
  const T* vb = v + (int64_t)kvh * sk * D;

  // keys [0, k_end) are visible to some valid row of this tile
  const int k_end = causal ? min(sk, q_offset + min(q0 + kSBQ, sq)) : sk;
  const int n_tiles = (k_end + kSBK - 1) / kSBK;

  load_tile<D>(qs, qb, q0, sq, tid);
  load_tile<D>(ks, kb, 0, sk, tid);
  cp_async_commit();
  load_tile<D>(vs, vb, 0, sk, tid);
  cp_async_commit();

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kSBK;
    cp_async_wait1();  // Q and K(t) landed (V(t) may be in flight)
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int it = 0; it < D / 16; ++it) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // the 16-byte chunk 4 it + u of a row
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              q_at + i * D + ((it ^ q_hi) << 4) + ((u ^ i) << 2));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              k_at + 16 * j * D + ((it ^ k_hi) << 4) + k_lo[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
    }
    __syncthreads();  // every thread is done reading ks
    if (t + 1 < n_tiles) load_tile<D>(ks, kb, k0 + kSBK, sk, tid);
    cp_async_commit();

    const bool need_mask =
        k0 + kSBK > sk || (causal && k0 + kSBK - 1 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (need_mask) {
          const int kpos = k0 + tx + 16 * j;
          if (kpos >= sk || (causal && kpos > qpos)) s[i][j] = -INFINITY;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - shift);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(fmaf(s[i][j], scale_log2, -shift));
        rs += s[i][j];
        ps[psw(4 * ty + i, tx + 16 * j)] = s[i][j];
      }
      l[i] = l[i] * alpha + rs;  // this thread's share; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    cp_async_wait1();  // V(t) landed (K(t+1) may be in flight)
    __syncthreads();   // P and V visible to every thread

    for (int k8 = 0; k8 < kSBK; k8 += 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // keys kk .. kk + 3
        const int kk = k8 + 4 * h;
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(ps + psw(4 * ty + i, kk));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float vv[DC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if constexpr (VEC == 4) {
              // row kk + e has (kk + e) % 8 = 4 h + e: its chunk 16 c + tx
              // sits at 16 c + (tx ^ (4 h + e))
              const float4 x = *reinterpret_cast<const float4*>(
                  vs + (kk + e) * D + 64 * c + v_lo[4 * h + e]);
              vv[4 * c] = x.x;
              vv[4 * c + 1] = x.y;
              vv[4 * c + 2] = x.z;
              vv[4 * c + 3] = x.w;
            } else {
              vv[c] = vs[sw<D>(kk + e, 16 * c + tx)];
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x
                           : e == 1 ? pv[i].y
                           : e == 2 ? pv[i].z
                                    : pv[i].w;
#pragma unroll
            for (int j = 0; j < DC; ++j)
              acc[i][j] = fmaf(p, vv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done reading vs and ps
    if (t + 1 < n_tiles) load_tile<D>(vs, vb, k0 + kSBK, sk, tid);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    const float inv = li > 0.f ? 1.f / li : 0.f;
    T* orow = o + ((int64_t)bh * sq + r) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 16 * VEC * c + VEC * tx;
      if constexpr (VEC == 4 && sizeof(T) == 4) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                        acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          store(orow + col + e, acc[i][VEC * c + e] * inv);
      }
    }
  }
}

// ------------------------------------------------------------------------
// wgmma route: bf16 on tensor cores, TMA-fed
// ------------------------------------------------------------------------
constexpr int kWBQ = 128;        // queries per block: 2 warpgroups x 64
constexpr int kWBK = 128;        // keys per tile
constexpr int kStages = 3;       // K/V ring slots
constexpr int kWThreads = 384;   // 2 consumer + 1 producer warpgroups
constexpr int kRowBytes = 128;   // one 64-column bf16 box row (swizzle span)

template <int D>
struct WLayout {
  static constexpr int kChunks = D / 64;             // 64-column boxes
  static constexpr int kQChunk = kWBQ * kRowBytes;   // bytes per Q box
  static constexpr int kKVChunk = kWBK * kRowBytes;  // bytes per K/V box
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kK = kQBytes;                   // ring of K tiles
  static constexpr int kV = kK + kStages * kKVBytes;   // ring of V tiles
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBars = 1 + 3 * kStages;  // q, k full, v full, empty
  // + 1024: the dynamic base is rounded up to the swizzle's 1024 bytes
  static constexpr int kBytes = 1024 + kBar + 8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one 64-column box of a (heads, rows, D) bf16 tensor into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keep the compiler from moving accumulator or fragment registers across
// the asynchronous wgmma (issue ... wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// The operand lists of the three wgmma shapes the kernel issues, written
// out: 64 x 128 scores (S = Q K^T, both operands in shared memory) and
// 64 x D outputs (O += P V, P from registers, V transposed).
// d (64 x 128) += A (64 x 16, shared) * B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

constexpr int kNS = kWBK / 2;    // score accumulators per thread
constexpr int kKS = kWBK / 16;   // k16 steps of P V

// issue (and commit) S = Q K^T for one warpgroup: K-major operands; a
// 16-column step is 32 bytes inside the 128-byte swizzled row, a
// 64-column step the next box.  Like issue_pv, it follows a wgmma_fence
// that comes after every write of the registers its wgmmas read: a write
// inside the stage would make ptxas serialize the wgmmas.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kNS], uint32_t q_at,
                                         uint32_t k_at) {
  static_assert(kWBK == 128, "a score tile is one m64n128 wgmma per k16");
  using L = WLayout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(
        s, sw128_desc(q_at + (kk >> 2) * L::kQChunk + (kk & 3) * 32, 16, 1024),
        sw128_desc(k_at + (kk >> 2) * L::kKVChunk + (kk & 3) * 32, 16, 1024),
        kk > 0);
  wgmma_commit();
}

// issue O += P V (not committed): V is D-contiguous (MN-major, the
// transpose bit); a 16-key step is 16 rows of 128 bytes, the next 64
// columns the next box
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[kKS][4],
                                         uint32_t v_at) {
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
    wgmma_rs<D>(o, p[kk],
                sw128_desc(v_at + kk * 16 * kRowBytes, WLayout<D>::kKVChunk,
                           1024));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Online softmax of one 64 x 128 score tile in the accumulator registers:
// masks (when asked), updates the running max m and sum l of the thread's
// two rows, leaves exp2 of the pre-scaled scores in s and returns in al0 /
// al1 the factors that rescale the rows' outputs.
// 2^x in one MUFU.EX2 (inputs of the softmax are <= 0; -inf gives +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
struct Rows {
  float m0, m1, l0, l1;
};
__device__ __forceinline__ void softmax_tile(float (&s)[kNS], Rows& r,
                                             float& al0, float& al1,
                                             bool need_mask, int k0, int sk,
                                             int causal, int qpos0, int c4,
                                             float scale_log2) {
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < kNS / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * c4 + (e & 1);
        const int qpos = qpos0 + 8 * (e >> 1);
        if (kpos >= sk || (causal && kpos > qpos)) s[4 * j + e] = -INFINITY;
      }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kNS / 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the quad that holds a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(r.m0, mx0 * scale_log2);
  const float mn1 = fmaxf(r.m1, mx1 * scale_log2);
  const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
  const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
  al0 = ex2(r.m0 - sh0);
  al1 = ex2(r.m1 - sh1);
  r.m0 = mn0;
  r.m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < kNS / 4; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -sh0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -sh0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -sh1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -sh1));
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  r.l0 = r.l0 * al0 + rs0;  // this thread's share; the quad sums at the end
  r.l1 = r.l1 * al1 + rs1;
}

// P as bf16 A fragments: the accumulator of keys 16 kk .. 16 kk + 15 is the
// A fragment of the kk-th k16 step of P V, rounded in place, no shuffle
__device__ __forceinline__ void pack_p(const float (&s)[kNS],
                                       uint32_t (&p)[kKS][4]) {
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float al0, float al1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= al0;
    o[4 * j + 1] *= al0;
    o[4 * j + 2] *= al1;
    o[4 * j + 3] *= al1;
  }
}

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            __nv_bfloat16* __restrict__ o, int bhq, int hq, int hkv, int sq,
            int sk, int n_qtiles, float scale_log2, int causal) {
  using L = WLayout<D>;
  constexpr int kNO = D / 2;  // output accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };
  auto k_at = [&](int s) { return base + L::kK + s * L::kKVBytes; };
  auto v_at = [&](int s) { return base + L::kV + s * L::kKVBytes; };

  const int tile = n_qtiles - 1 - (int)(blockIdx.x / bhq);  // heaviest first
  const int bh = (int)(blockIdx.x % bhq);
  const int b = bh / hq;
  const int kvh = b * hkv + (bh - b * hq) / (hq / hkv);
  const int q0 = tile * kWBQ;
  const int q_offset = sk - sq;
  const int k_end = causal ? min(sk, q_offset + min(q0 + kWBQ, sq)) : sk;
  const int n_tiles = (k_end + kWBK - 1) / kWBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: gives its registers to the consumers; one
    // thread issues every TMA copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(base + c * L::kQChunk, &tq, bar_q, 64 * c, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty(s), ((t / kStages) - 1) & 1);
        mbar_expect_tx(k_full(s), L::kKVBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(k_at(s) + c * L::kKVChunk, &tk, k_full(s), 64 * c,
                   t * kWBK, kvh);
        mbar_expect_tx(v_full(s), L::kKVBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(v_at(s) + c * L::kKVChunk, &tv, v_full(s), 64 * c,
                   t * kWBK, kvh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumer warpgroup wg owns query rows [row0, row0 + 64) of the tile;
    // this thread holds rows row0 + 16 w + g and + 8, key / column pairs
    // 8 j + 2 c4 (+1) of the accumulators
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, c4 = lane & 3;
    const int row0 = q0 + 64 * wg;
    const int k_end_wg =
        causal ? min(sk, q_offset + min(row0 + 64, sq)) : sk;
    const int n_mine = row0 < sq ? (k_end_wg + kWBK - 1) / kWBK : 0;
    // tiles [0, n_plain) need no mask; the masked ones are a suffix
    int n_plain = min(n_mine, sk / kWBK);
    if (causal) n_plain = min(n_plain, (q_offset + row0 + 1) / kWBK);
    const int qpos0 = q_offset + row0 + 16 * w + g;
    const uint32_t q_at = base + (64 * wg) * kRowBytes;

    float s_acc[kNS], o_acc[kNO], al0, al1;
    uint32_t p_frag[kKS][4], lo_frag[kKS][4];
#pragma unroll
    for (int i = 0; i < kNS; ++i) s_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kNO; ++i) o_acc[i] = 0.f;
    Rows r = {-INFINITY, -INFINITY, 0.f, 0.f};
    mbar_wait(bar_q, 0);

    // unmasked tiles, software-pipelined: S of tile t is issued before
    // P V of tile t-1, and the softmax of tile t runs while P V of tile
    // t-1 is still on the tensor cores
    if (n_plain > 0) {
      mbar_wait(k_full(0), 0);
      fence_regs(s_acc);
      wgmma_fence();
      issue_qk<D>(s_acc, q_at, k_at(0));
      wgmma_wait<0>();
      fence_regs(s_acc);
      softmax_tile(s_acc, r, al0, al1, false, 0, sk, causal, qpos0, c4,
                   scale_log2);
      pack_p(s_acc, p_frag);
      for (int t = 1; t < n_plain; ++t) {
        const int s = t % kStages, ps = (t - 1) % kStages;
        mbar_wait(k_full(s), (t / kStages) & 1);
        mbar_wait(v_full(ps), ((t - 1) / kStages) & 1);
        fence_regs(s_acc);
        fence_regs(o_acc);
        fence_regs(p_frag);
        wgmma_fence();
        issue_qk<D>(s_acc, q_at, k_at(s));
        issue_pv<D>(o_acc, p_frag, v_at(ps));
        wgmma_commit();
        wgmma_wait<1>();  // S of tile t is done
        fence_regs(s_acc);
        // in place, and P packed only after the wait below: a register
        // that no wgmma of the running stage reads (as a new P would be)
        // may be given the registers of the in-flight P, and ptxas then
        // serializes the wgmmas
        softmax_tile(s_acc, r, al0, al1, false, t * kWBK, sk, causal, qpos0,
                     c4, scale_log2);
        wgmma_wait<0>();  // P V of tile t-1 is done
        fence_regs(o_acc);
        fence_regs(p_frag);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(ps));
        rescale(o_acc, al0, al1);
        pack_p(s_acc, p_frag);
      }
      const int s = (n_plain - 1) % kStages;
      mbar_wait(v_full(s), ((n_plain - 1) / kStages) & 1);
      fence_regs(o_acc);
      fence_regs(p_frag);
      wgmma_fence();
      issue_pv<D>(o_acc, p_frag, v_at(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(p_frag);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // masked tiles (the diagonal, the ragged last key tile), one at a
    // time.  Here P also goes through a second bf16 product of its
    // rounding residual P - bf16(P): rows that see few keys
    // (all of them within these tiles) average few values of V, and bf16
    // P alone would shift such an output by up to ~2^-9 of |V| where the
    // output itself may cancel to near zero; rows that see many keys
    // average the rounding away.
    for (int t = n_plain; t < n_mine; ++t) {
      const int s = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      mbar_wait(k_full(s), par);
      fence_regs(s_acc);
      wgmma_fence();
      issue_qk<D>(s_acc, q_at, k_at(s));
      wgmma_wait<0>();
      fence_regs(s_acc);
      softmax_tile(s_acc, r, al0, al1, true, t * kWBK, sk, causal, qpos0, c4,
                   scale_log2);
      pack_p(s_acc, p_frag);
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 h = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&p_frag[kk][i]));
          lo_frag[kk][i] = pack_bf16(s_acc[8 * kk + 2 * i] - h.x,
                                    s_acc[8 * kk + 2 * i + 1] - h.y);
        }
      rescale(o_acc, al0, al1);
      mbar_wait(v_full(s), par);
      fence_regs(o_acc);
      fence_regs(p_frag);
      fence_regs(lo_frag);
      wgmma_fence();
      issue_pv<D>(o_acc, p_frag, v_at(s));
      issue_pv<D>(o_acc, lo_frag, v_at(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(p_frag);
      fence_regs(lo_frag);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // tiles past this warpgroup's rows: only released, in step with the
    // ring (waiting for them first keeps a slot's arrivals in one phase)
    for (int t = n_mine; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      mbar_wait(k_full(s), par);
      mbar_wait(v_full(s), par);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    if (row0 < sq) {
      float l0 = r.l0, l1 = r.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
      const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      const int r0 = row0 + 16 * w + g, r1 = r0 + 8;
      __nv_bfloat16* o0 = o + ((int64_t)bh * sq + r0) * D + 2 * c4;
      __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
      for (int j = 0; j < kNO / 4; ++j) {
        if (r0 < sq)
          *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
              __floats2bfloat162_rn(o_acc[4 * j] * inv0,
                                    o_acc[4 * j + 1] * inv0);
        if (r1 < sq)
          *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
              __floats2bfloat162_rn(o_acc[4 * j + 2] * inv1,
                                    o_acc[4 * j + 3] * inv1);
      }
    }
  }
}

}  // namespace

namespace {

enum Route { kSimt = 0, kWgmma = 1 };

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (heads, rows, d) bf16 tensor, read in (1, box_rows, 64) boxes with the
// 128-byte swizzle; rows past `rows` read as zeros
cudaError_t make_map(CUtensorMap* map, const void* ptr, int d, int rows,
                     int heads, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int smem_bytes(int route, int d) {
  if (route == kWgmma) {
    switch (d) {
      case 64: return WLayout<64>::kBytes;
      case 128: return WLayout<128>::kBytes;
      default: return -1;
    }
  }
  switch (d) {
    case 16: return simt_smem_bytes<16>();
    case 32: return simt_smem_bytes<32>();
    case 64: return simt_smem_bytes<64>();
    case 128: return simt_smem_bytes<128>();
    case 256: return simt_smem_bytes<256>();
    default: return -1;
  }
}

template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        int bhq, int hq, int hkv, int sq, int sk, int n_qt,
                        int causal, float scale_log2, cudaStream_t stream) {
  const int smem = simt_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_simt<T, D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) return err;
  flash_simt<T, D><<<(unsigned)(n_qt * (int64_t)bhq), kSThreads, smem,
                      stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bhq, hq, hkv, sq, sk,
      n_qt, scale_log2, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int b, int hq, int hkv, int sq, int sk,
                         int n_qt, int causal, float scale_log2,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, D, sq, b * hq, kWBQ);
  if (err == cudaSuccess) err = make_map(&tk, k, D, sk, b * hkv, kWBK);
  if (err == cudaSuccess) err = make_map(&tv, v, D, sk, b * hkv, kWBK);
  if (err != cudaSuccess) return err;
  const int smem = WLayout<D>::kBytes;
  err = cudaFuncSetAttribute(flash_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  flash_wgmma<D><<<(unsigned)(n_qt * (int64_t)(b * hq)), kWThreads, smem,
                   stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                             b * hq, hq, hkv, sq, sk, n_qt, scale_log2,
                             causal);
  return cudaGetLastError();
}

// f32 at every head dim; bf16 only at D = 16, 32 and 256 (the wgmma
// route takes 64 and 128)
template <typename T>
cudaError_t launch_simt_d(const void* q, const void* k, const void* v,
                          void* o, int bhq, int hq, int hkv, int sq, int sk,
                          int d, int n_qt, int causal, float sl2,
                          cudaStream_t s) {
  switch (d) {
    case 16: return launch_simt<T, 16>(q, k, v, o, bhq, hq, hkv, sq, sk, n_qt, causal, sl2, s);
    case 32: return launch_simt<T, 32>(q, k, v, o, bhq, hq, hkv, sq, sk, n_qt, causal, sl2, s);
    case 256: return launch_simt<T, 256>(q, k, v, o, bhq, hq, hkv, sq, sk, n_qt, causal, sl2, s);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {
    switch (d) {
      case 64: return launch_simt<T, 64>(q, k, v, o, bhq, hq, hkv, sq, sk, n_qt, causal, sl2, s);
      case 128: return launch_simt<T, 128>(q, k, v, o, bhq, hq, hkv, sq, sk, n_qt, causal, sl2, s);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch geometry of a route (0 simt, 1 wgmma) at head dim d: out[0]
// queries per block, out[1] threads per block, out[2] dynamic shared
// bytes.  Returns 0, or -1 for a (route, d) the kernel does not take.
extern "C" int flash_attention_geometry(int route, int d, int* out) {
  const int smem = smem_bytes(route, d);
  if (smem < 0) return -1;
  out[0] = route == kWgmma ? kWBQ : kSBQ;
  out[1] = route == kWgmma ? kWThreads : kSThreads;
  out[2] = smem;
  return 0;
}

// q (b*hq, sq, d), k and v (b*hkv, sk, d), o like q; all contiguous, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1).  route 1 (wgmma) takes
// bf16 at d = 64 or 128; route 0 (simt) takes f32 at d = 16, 32, 64, 128
// or 256 and bf16 at d = 16, 32 or 256.  hq is a multiple of hkv; sq >= 1,
// sk >= 1, and sq <= sk when causal.  Returns a cudaError_t code (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int sq, int sk, int d,
                                      int causal, float scale, int bf16,
                                      int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int geo[3];
  if (flash_attention_geometry(route, d, geo) != 0 ||
      (route == kWgmma && !bf16))
    return cudaErrorInvalidValue;
  const int n_qt = (sq + geo[0] - 1) / geo[0];
  if ((int64_t)n_qt * b * hq > 0x7fffffff) return cudaErrorInvalidValue;
  const float sl2 = scale * kLog2e;
  if (route == kWgmma)
    return d == 128 ? launch_wgmma<128>(q, k, v, o, b, hq, hkv, sq, sk, n_qt,
                                        causal, sl2, s)
                    : launch_wgmma<64>(q, k, v, o, b, hq, hkv, sq, sk, n_qt,
                                       causal, sl2, s);
  if (bf16)
    return launch_simt_d<__nv_bfloat16>(q, k, v, o, b * hq, hq, hkv, sq, sk,
                                        d, n_qt, causal, sl2, s);
  return launch_simt_d<float>(q, k, v, o, b * hq, hq, hkv, sq, sk, d, n_qt,
                              causal, sl2, s);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
