// Stable radix partition for Hopper (sm_90a): the shuffle's bucketize.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/radix_partition/radix_partition.py::radix_partition_pallas
// (body `_kernel`, wrapper `ops.radix_partition`).  For every row of
// `dest` (p ranks x n rows, int32 in [0, nb)) it computes the row's stable
// rank within its bucket (the number of earlier rows of the same rank with
// the same bucket) and each rank's bucket histogram.
//
// What bounds it: bytes.  The function reads 4 bytes and writes 4 bytes per
// row plus the (p, nb) histogram; there is no arithmetic to speak of.
//
// Design.  The TPU kernel carries a running histogram across row blocks of
// a sequential grid.  Here blocks run in parallel, so the carry becomes an
// exclusive scan over per-tile histograms (three launches):
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

}  // namespace

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
