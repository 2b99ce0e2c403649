// Stable radix partition for Hopper (sm_90a): the shuffle's bucketize.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/radix_partition/radix_partition.py:57
//   (radix_partition_pallas; body `_kernel`, wrapper `ops.radix_partition`).
// For every row of `dest` (p ranks x n rows, int32 in [0, nb)) it computes
// the row's stable rank within its bucket (the number of earlier rows of the
// same rank with the same bucket) and each rank's bucket histogram.  Rows
// whose value lies outside [0, nb) are counted nowhere and get rank 0.
//
// What bounds it: bytes.  The function reads 4 bytes of dest and writes 4
// bytes of rank per row, plus the (p, nb) histogram: 8 bytes a row, and no
// arithmetic to speak of.
//
// The TPU kernel carries a running histogram across the row blocks of a
// sequential grid.  Blocks run in parallel here, so the carry becomes a scan
// over per-tile bucket counts.  Two routes, picked by nb alone (cuda.py):
//
// onepass (nb <= 256): one launch, the single-pass scan with decoupled
// look-back of Merrill and Garland (2016), as CUB's onesweep radix sort runs
// it per digit.  Against the three-pass design below it removes three costs:
// two extra launches (a scan grid of only nb x p blocks among them); a second
// read of dest and a second walk of each tile (8 bytes a row instead of 12
// or more); and rows loaded 4 bytes at a time, each load followed by a
// dependent shared-memory update, which left few bytes in flight.
//   * Tile ids come from an atomic ticket, so a block only waits on blocks
//     that have started.  Ticket t is tile t / p of rank t % p: tiles run in
//     order within a rank, and the ranks' chains advance side by side.
//   * A block (256 threads) takes an 8192-row tile.  It reads it once, with
//     16-byte streaming loads (8 per thread, all issued before the first is
//     used; each warp's loads contiguous), into shared memory, and writes
//     the ranks back the same way.  Pad rows of a ragged last tile take
//     bucket nb.  For n not a multiple of 4 (or a misaligned dest) the same
//     kernel moves 4 bytes a row.
//   * Each warp ranks 1024 consecutive rows, 32 at a time in row order: a
//     match over the bucket's bits (one ballot per bit) gives each lane its
//     peers, and the lowest peer adds the group's size to the warp's
//     counter with one shared atomic, whose old value it hands to its
//     peers.  A warp whose 32 rows share a bucket (the sort's padding) costs
//     one update.  No global atomic touches the row path.
//   * Thread b scans bucket b's count over the 8 warps and publishes the
//     tile's count as an aggregate (a 64-bit status word: flag in the high
//     half, count in the low half, st.release.gpu).  The block then walks
//     back over its predecessors in windows of min(32, 256 / nb) tiles a
//     bucket (volatile loads) until each bucket meets an inclusive prefix,
//     and publishes its own.  Look-back never crosses into the previous
//     rank.  The last tile of a rank writes its histogram row.
//   * Rank = rank within the warp + earlier warps + the tile's exclusive
//     prefix: in-warp row order, then earlier warps, then earlier tiles.
//     The status words (p x nb x tiles) and the ticket are zeroed by a
//     cudaMemsetAsync before each launch.
//   * What remains between it and its bound (measured with per-phase
//     %globaltimer stamps and by taking phases out): the ranking is bound by
//     the SM's issue rate while five blocks share it, and each tile waits
//     an L2 round trip or more in the look-back, mostly on a predecessor
//     that has not yet published; the load and store phases alone run at
//     85% of the bound.
//
// threepass (nb up to 32768, where a look-back over nb status words per tile
// would cost more than two launches): three kernels.
//   1. rp_count: each block counts the buckets of one 8192-row tile of one
//      rank (blockIdx.y = rank) into tile_hist[rank][bucket][tile];
//   2. rp_scan:  one block per (bucket, rank) scans that bucket's tile
//      counts into exclusive tile offsets, and writes the histogram;
//   3. rp_rank:  each block re-counts its tile per warp, turns the warp
//      counts into per-warp starting offsets (tile offset + earlier warps),
//      and walks its rows in order.  Inside a warp, __match_any_sync groups
//      the lanes that share a bucket and __popc(peers & lanemask_lt) ranks
//      a lane among them, so ranks are stable without atomics.
// Each warp owns a contiguous sub-tile and a row of `nb` counters in shared
// memory; for a large nb the wrapper runs fewer warps per block so the
// (warps x nb) table still fits.  Rows past the end of a rank (the ragged
// last tile) and values outside [0, nb) take the pad bucket nb, past every
// real bucket, and are never counted -- the padding rule of the JAX
// wrapper (ops.py) without materialising any padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8192;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 256;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm volatile("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int bucket_of(const int* __restrict__ d,
                                         int64_t i, int64_t hi, int nb) {
  if (i >= hi) return nb;
  const int b = d[i];
  return (b >= 0 && b < nb) ? b : nb;
}

// Adds the bucket counts of rows [lo, hi) to this warp's counter row.
// lo and hi are the same in every lane of the warp.
__device__ void warp_count(const int* __restrict__ d, int64_t lo, int64_t hi,
                           int nb, int* row) {
  const unsigned lane = threadIdx.x & 31;
  for (int64_t base = lo; base < hi; base += 32) {
    const int b = bucket_of(d, base + lane, hi, nb);
    const unsigned peers = __match_any_sync(kFull, b);
    if (b < nb && (peers & lanemask_lt()) == 0) row[b] += __popc(peers);
    __syncwarp();
  }
}

// Writes the stable rank of rows [lo, hi); `row` holds this warp's
// starting offset per bucket and is advanced as the warp walks its rows.
__device__ void warp_rank(const int* __restrict__ d, int64_t lo, int64_t hi,
                          int nb, int* row, int* __restrict__ ranks) {
  const unsigned lane = threadIdx.x & 31;
  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t i = base + lane;
    const int b = bucket_of(d, i, hi, nb);
    const unsigned peers = __match_any_sync(kFull, b);
    const bool leader = (peers & lanemask_lt()) == 0;
    int r = 0;
    if (b < nb) r = row[b] + __popc(peers & lanemask_lt());
    if (i < hi) ranks[i] = r;
    __syncwarp();
    if (b < nb && leader) row[b] += __popc(peers);
    __syncwarp();
  }
}

// This warp's row range inside tile `tile` of a rank with n rows.
__device__ __forceinline__ void warp_range(int tile, int warps, int n,
                                           int64_t* lo, int64_t* hi) {
  const int w = threadIdx.x >> 5;
  const int sub = kTileRows / warps;
  *lo = (int64_t)tile * kTileRows + (int64_t)w * sub;
  const int64_t end = *lo + sub;
  *hi = end < (int64_t)n ? end : (int64_t)n;
}

__global__ void rp_count(const int* __restrict__ dest, int n, int nb,
                         int tiles, int warps, int* __restrict__ tile_hist) {
  extern __shared__ int counts[];  // [warps][nb]
  const int tile = blockIdx.x, rank = blockIdx.y;
  const int* d = dest + (int64_t)rank * n;
  for (int j = threadIdx.x; j < warps * nb; j += blockDim.x) counts[j] = 0;
  __syncthreads();
  int64_t lo, hi;
  warp_range(tile, warps, n, &lo, &hi);
  warp_count(d, lo, hi, nb, counts + (threadIdx.x >> 5) * nb);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int s = 0;
    for (int k = 0; k < warps; ++k) s += counts[k * nb + b];
    tile_hist[((int64_t)rank * nb + b) * tiles + tile] = s;
  }
}

__global__ void rp_scan(const int* __restrict__ tile_hist, int tiles, int nb,
                        int* __restrict__ tile_off, int* __restrict__ hist) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int b = blockIdx.x, rank = blockIdx.y;
  const int64_t row = ((int64_t)rank * nb + b) * tiles;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? tile_hist[row + i] : 0;
    int x = v;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[w] = x;
    __syncthreads();
    if (w == 0) {  // inclusive scan over the warp totals
      int s = lane < nw ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const int before = carry + (w > 0 ? warp_sums[w - 1] : 0);
    if (i < tiles) tile_off[row + i] = before + x - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = before + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) hist[(int64_t)rank * nb + b] = carry;
}

__global__ void rp_rank(const int* __restrict__ dest, int n, int nb,
                        int tiles, int warps,
                        const int* __restrict__ tile_off,
                        int* __restrict__ ranks) {
  extern __shared__ int counts[];  // [warps][nb]
  const int tile = blockIdx.x, rank = blockIdx.y;
  const int* d = dest + (int64_t)rank * n;
  for (int j = threadIdx.x; j < warps * nb; j += blockDim.x) counts[j] = 0;
  __syncthreads();
  int64_t lo, hi;
  warp_range(tile, warps, n, &lo, &hi);
  int* mine = counts + (threadIdx.x >> 5) * nb;
  warp_count(d, lo, hi, nb, mine);
  __syncthreads();
  // per-warp starting offsets: the tile's offset plus the earlier warps
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int running = tile_off[((int64_t)rank * nb + b) * tiles + tile];
    for (int k = 0; k < warps; ++k) {
      const int c = counts[k * nb + b];
      counts[k * nb + b] = running;
      running += c;
    }
  }
  __syncthreads();
  warp_rank(d, lo, hi, nb, mine, ranks + (int64_t)rank * n);
}

// ------------------------------------------------------------------------
// onepass route
// ------------------------------------------------------------------------
constexpr int kOneThreads = 256;
constexpr int kOneWarps = kOneThreads / 32;
constexpr int kItems = 32;                        // rows per thread
constexpr int kOneTile = kOneThreads * kItems;    // rows per tile
constexpr int kWarpRows = 32 * kItems;            // rows per warp
constexpr int kMaxOneBuckets = kOneThreads;       // one thread per bucket
constexpr int kMaxWindow = 32;                    // tiles a bucket, a round
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

// A status word: the flag in the high half, the count in the low half, so
// one 64-bit store publishes both; written with release semantics, read with
// volatile loads (L2, never a stale L1 line).
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.volatile.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Lanes of the warp whose label equals this lane's, from one ballot per bit
// of the label (labels are below 2^bits).
__device__ __forceinline__ unsigned match_bits(int label, int bits) {
  unsigned peers = kFull;
  for (int i = 0; i < bits; ++i) {
    const unsigned m = __ballot_sync(kFull, (label >> i) & 1);
    peers &= ((label >> i) & 1) ? m : ~m;
  }
  return peers;
}

// A rank's final value from the packed (rank in warp << 16 | bucket) word;
// `offsets` holds the warp's starting offset per bucket.
__device__ __forceinline__ int final_rank(int v, const int* offsets, int nb) {
  const int b = v & 0xffff;
  return b < nb ? (v >> 16) + offsets[b] : 0;
}

template <bool kVec>
__global__ void __launch_bounds__(kOneThreads, 4)
rp_onepass(const int* __restrict__ dest, int* __restrict__ ranks,
           int* __restrict__ hist, unsigned long long* __restrict__ status,
           unsigned* __restrict__ ticket, int p, int n, int nb, int bits,
           int tiles) {
  __shared__ __align__(16) int s_rows[kOneTile];       // dest, then ranks
  __shared__ int s_cnt[kOneWarps][kMaxOneBuckets];     // per-warp counts
  __shared__ unsigned long long s_win[kOneThreads];    // look-back window
  __shared__ unsigned s_excl[kMaxOneBuckets];          // prefix so far
  __shared__ int s_next[kMaxOneBuckets];               // tiles left to see
  __shared__ unsigned s_ticket;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1u);
  for (int k = 0; k < kOneWarps; ++k)
    if (tid < nb) s_cnt[k][tid] = 0;
  __syncthreads();
  const int rank = (int)(s_ticket % (unsigned)p);
  const int tile = (int)(s_ticket / (unsigned)p);
  const int64_t row0 = (int64_t)tile * kOneTile;
  const int rows = n - row0 < kOneTile ? (int)(n - row0) : kOneTile;
  const int64_t base = (int64_t)rank * n + row0;

  // 1. the tile of dest, read once, into shared memory; rows past the
  // rank's end take the pad bucket nb
  if (kVec) {  // rows is a multiple of 4 here
    const int4* src = reinterpret_cast<const int4*>(dest + base);
    int4* dst = reinterpret_cast<int4*>(s_rows);
    int4 v[kItems / 4];
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int q = k * kOneThreads + tid;
      v[k] = 4 * q < rows ? __ldcs(src + q) : make_int4(nb, nb, nb, nb);
    }
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) dst[k * kOneThreads + tid] = v[k];
  } else {
    int v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kOneThreads + tid;
      v[k] = i < rows ? __ldcs(dest + base + i) : nb;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) s_rows[k * kOneThreads + tid] = v[k];
  }
  __syncthreads();
  const int window = kOneThreads / nb < kMaxWindow ? kOneThreads / nb
                                                   : kMaxWindow;
  const int wb = tid % nb, wo = tid / nb;
  const unsigned long long* wst = status + ((int64_t)rank * nb + wb) * tiles;

  // 2. stable rank within the warp's rows, 32 rows a step in row order
  {
    const unsigned lt = lanemask_lt();
    int* cnt = s_cnt[w];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = w * kWarpRows + j * 32 + lane;
      int b = s_rows[i];
      b = (unsigned)b < (unsigned)nb ? b : nb;
      const unsigned peers = match_bits(b, bits);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader && b < nb) before = atomicAdd(cnt + b, __popc(peers));
      before = __shfl_sync(kFull, before, leader);
      s_rows[i] = ((before + __popc(peers & lt)) << 16) | b;
    }
  }
  __syncthreads();

  // 3. per bucket: exclusive offsets over the warps and the tile's count,
  // published as an aggregate (tile 0 publishes its inclusive prefix)
  unsigned agg = 0;
  unsigned long long* st = status + ((int64_t)rank * nb + tid) * tiles;
  if (tid < nb) {
    int run = 0;
    for (int k = 0; k < kOneWarps; ++k) {
      const int c = s_cnt[k][tid];
      s_cnt[k][tid] = run;
      run += c;
    }
    agg = (unsigned)run;
    store_status(st + tile, (tile == 0 ? kInclusive : kAggregate) | agg);
    s_excl[tid] = 0;
    s_next[tid] = tile;
  }
  __syncthreads();

  // 4. decoupled look-back: each round, thread (o, b) reads bucket b's
  // status o + 1 tiles before the first tile not yet seen; thread b then
  // adds the window up to the nearest inclusive prefix, or stops at a tile
  // that has published nothing yet and reads again from there
  if (tile > 0) {
    int more = 1;
    while (more) {
      if (wo < window) {
        const int k = s_next[wb] - 1 - wo;
        s_win[wo * nb + wb] = k >= 0 ? load_status(wst + k) : kInclusive;
      }
      __syncthreads();
      int pending = 0;
      if (tid < nb && s_next[tid] > 0) {
        int k = s_next[tid];
        unsigned excl = s_excl[tid];
        for (int o = 0; o < window; ++o) {
          const unsigned long long s = s_win[o * nb + tid];
          if ((s >> 32) == 0) break;  // not published yet: read again
          excl += (unsigned)s;
          --k;
          if ((s & ~0xffffffffull) == kInclusive) {
            k = 0;
            break;
          }
        }
        s_excl[tid] = excl;
        s_next[tid] = k;
        pending = k > 0;
      }
      more = __syncthreads_or(pending);
    }
  }

  // 5. publish the inclusive prefix, write the histogram from the last
  // tile, and fold the tile's offset into the warps' offsets
  if (tid < nb) {
    const unsigned excl = s_excl[tid];
    if (tile > 0) store_status(st + tile, kInclusive | (excl + agg));
    if (tile == tiles - 1) hist[(int64_t)rank * nb + tid] = (int)(excl + agg);
    for (int k = 0; k < kOneWarps; ++k) s_cnt[k][tid] += (int)excl;
  }
  __syncthreads();

  // 6. the ranks, written once
  if (kVec) {
    int4* out = reinterpret_cast<int4*>(ranks + base);
    const int4* src = reinterpret_cast<const int4*>(s_rows);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int q = k * kOneThreads + tid;
      if (4 * q < rows) {
        int4 v = src[q];
        const int* off = s_cnt[(4 * q) / kWarpRows];
        v.x = final_rank(v.x, off, nb);
        v.y = final_rank(v.y, off, nb);
        v.z = final_rank(v.z, off, nb);
        v.w = final_rank(v.w, off, nb);
        __stcs(out + q, v);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kOneThreads + tid;
      if (i < rows)
        __stcs(ranks + base + i,
               final_rank(s_rows[i], s_cnt[i / kWarpRows], nb));
    }
  }
}

}  // namespace

// onepass route.  dest, ranks: (p, n) int32; hist: (p, nb) int32, nb <= 256;
// scratch: radix_partition_onepass_scratch(p, n, nb) bytes, zeroed here
// before the launch.  vec: 16-byte loads and stores (n a multiple of 4, dest
// and ranks 16-byte aligned).  Returns 0 or the first CUDA error.  Launches
// on `stream`, does not sync.
extern "C" int radix_partition_onepass(const int* dest, int* ranks, int* hist,
                                       void* scratch, int p, int n, int nb,
                                       int vec, cudaStream_t stream) {
  if (nb < 1 || nb > kMaxOneBuckets) return cudaErrorInvalidValue;
  const int tiles = (n + kOneTile - 1) / kOneTile;
  cudaError_t err;
  if (tiles == 0)
    return cudaMemsetAsync(hist, 0, (size_t)p * nb * sizeof(int), stream);
  const size_t words = (size_t)p * nb * tiles;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(status + words);
  err = cudaMemsetAsync(scratch, 0, (words + 1) * sizeof(unsigned long long),
                        stream);
  if (err != cudaSuccess) return err;
  int bits = 1;  // labels run over [0, nb]: nb is the pad bucket
  while ((1 << bits) <= nb) ++bits;
  const int64_t blocks = (int64_t)p * tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (vec)
    rp_onepass<true><<<(unsigned)blocks, kOneThreads, 0, stream>>>(
        dest, ranks, hist, status, ticket, p, n, nb, bits, tiles);
  else
    rp_onepass<false><<<(unsigned)blocks, kOneThreads, 0, stream>>>(
        dest, ranks, hist, status, ticket, p, n, nb, bits, tiles);
  return cudaGetLastError();
}

// Bytes of scratch the onepass route needs: the status words and the ticket.
extern "C" long long radix_partition_onepass_scratch(int p, int n, int nb) {
  const long long tiles = (n + (long long)kOneTile - 1) / kOneTile;
  return ((long long)p * nb * tiles + 1) *
         (long long)sizeof(unsigned long long);
}

// The kernels' constants, for the wrapper's mirror of them: rows per onepass
// tile, the onepass route's largest nb, rows per threepass tile.
extern "C" void radix_partition_constants(int* out) {
  out[0] = kOneTile;
  out[1] = kMaxOneBuckets;
  out[2] = kTileRows;
}

// threepass route.
// dest, ranks: (p, n) int32; hist: (p, nb) int32; scratch: 2 * p * nb *
// ceil(n / 8192) int32.  `warps` * nb * 4 bytes of shared memory per block.
// Returns 0 or the first CUDA error.  Launches on `stream`, does not sync.
extern "C" int radix_partition_launch(const int* dest, int* ranks, int* hist,
                                      int* scratch, int p, int n, int nb,
                                      int warps, cudaStream_t stream) {
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const size_t smem = (size_t)warps * nb * sizeof(int);
  int* tile_hist = scratch;
  int* tile_off = scratch + (size_t)p * nb * tiles;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rp_count,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(rp_rank,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (tiles > 0) {
    rp_count<<<dim3(tiles, p), warps * 32, smem, stream>>>(dest, n, nb, tiles,
                                                           warps, tile_hist);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rp_scan<<<dim3(nb, p), kScanThreads, 0, stream>>>(tile_hist, tiles, nb,
                                                    tile_off, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (tiles > 0) {
    rp_rank<<<dim3(tiles, p), warps * 32, smem, stream>>>(
        dest, n, nb, tiles, warps, tile_off, ranks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}

extern "C" const char* radix_partition_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
