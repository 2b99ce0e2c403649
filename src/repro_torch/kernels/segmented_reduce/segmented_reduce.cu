// Segmented sum for Hopper (sm_90a): the groupby's sum, count and size.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segmented_reduce/segmented_reduce.py:50
//   (segmented_sum_pallas; body `_kernel`, wrapper `ops.segmented_sum`).
// For every rank r of p and every value column c of C it computes
//   out[r, s, c] = sum of values[r, i, c] over the rows i with seg[r, i] == s
// for s in [0, S); rows whose id lies outside [0, S) add nothing, as JAX
// drops out-of-range segment updates.
//
// What bounds it: bytes.  The function reads 4 bytes of id and C values per
// row and writes the (S, C) sums once; it does one addition per value.
//
// The TPU kernel turns each row block into a one-hot matrix and multiplies
// it on the MXU, with the output tile resident in VMEM across a sequential
// grid of row blocks; that is right for ids in any order.  Blocks run in
// parallel here and nothing stays resident, so there are two routes, picked
// by the caller's word alone (cuda.py: route_for):
//
// sorted (ids non-decreasing within each rank, as groupby_local hands them
// over): a single-pass reduce-by-key with decoupled look-back (Merrill and
// Garland 2016, the pattern of radix_partition.cu's onepass route).  Every
// output slot is written exactly once, with plain stores: no zero-fill of
// the output and no atomics on it.  What held the atomic route back, and
// what this route does about it:
//   * bytes in flight: each thread loads its 16 consecutive rows (8 of
//     8-byte values) with four 16-byte loads of ids and of values, all
//     issued before any is used (4-byte loads through shared memory when
//     C > 1 or the rank's rows are not 16-byte aligned); 256 threads a
//     tile, three tiles an SM (up to 80 registers: at 64 the registers
//     spilled, and the served groupby's call took a fifth longer).
//   * a memset and a read-modify-write of every slot: none.  Slot s
//     belongs to the tile, and in it to the warp, that holds the last row
//     with id <= s: a run's own slot where the run ends, and the gap after
//     it.  A warp's slots [wlo, whi) are contiguous.  Where its run ends
//     lie within 1024 slots of wlo (the groupby's ids count up by one),
//     the warp scatters their sums straight from registers into shared
//     memory, zero-filled first only if a slot has no run, and writes that
//     stretch out in whole sectors; a sparser warp goes out by units of
//     32 / sizeof(T) slots (32 bytes when C == 1, aligned in the flattened
//     output), the lane of a unit's first run end writing the unit, sums
//     and zeros at once, and the lane of the run end before a stretch of
//     units without one writing that stretch.  So a sparse warp (the 99%
//     segment's last 1% of ids) costs its run ends, not its slots, and no
//     sector is written in two parts (which can cost the memory a
//     read-modify-write).  Stretches of 64 or more slots in whole units
//     with no run end (the tail of a staged warp, the gaps of a sparse one)
//     are not written by the tile: the warp puts them, cut into pieces of
//     2048 slots, on a list in scratch (one atomic a warp; a long stretch's
//     pieces written by all its lanes), and a second small launch over a
//     fixed grid zero-fills the pieces, reading the list's length on the
//     device (no host sync).  One block writes only some 30-60 GB/s, so a
//     gap of 91% of S (the groupby's padding rows at cap - 1 on Fig-9's
//     call) must not stay with the tile it falls in.
//   * Columns (C > 1): a block takes one column of a tile, with a
//     look-back chain of its own; the C blocks of a tile have consecutive
//     tickets and run side by side, so the tile's ids and value lines come
//     from HBM once and from L2 for the other columns.  (A loop over the
//     columns in one block, each restaged through shared memory, took
//     1.4-1.8x the atomic route's time at (8, 2^20, C = 4) on an H100.)
//   * Tiles come from an atomic ticket (ticket t is column t % C of tile
//     t / C / p of rank t / C % p), so a tile only waits on tiles that have
//     started.  A thread sums its rows by run; a block-wide segmented scan
//     over the threads' open runs gives each thread the part of its first
//     run that earlier threads hold.  Only the tile's first slot can
//     depend on earlier tiles: the run continuing into it.  Every tile
//     publishes its last run's partial once, right after the scan and
//     before it writes its slots: inclusive when the run starts in the
//     tile, else (the tile is one run from its predecessor on to its
//     successor, as in the 99% segment and the padding run) an aggregate,
//     and such a tile has no slot of its own and is done.  No tile waits to
//     publish, so a run over thousands of tiles forms no chain.  The tile
//     in which the run ends looks back: warp 0 over its 32 nearest
//     predecessors, then, for a longer run, the whole block over 1024 a
//     round, until it finds the nearest inclusive partial with every
//     nearer one published, and adds them up.  Status is one 64-bit word a
//     tile and column (flag and partial) for 4-byte values, else a 32-bit
//     flag published with st.release.gpu after the partial it covers.
//   * Determinism: a carry is the tile's own part of the run plus the
//     predecessors' partials from the nearest inclusive one on, each round
//     summed by a fixed tree over fixed positions; every partial is written
//     once, and which ones are summed depends on the ids alone.  Within a
//     tile the order is the thread's row order and the scan's fixed tree.
//     So the sorted route's float sums are bit-identical from run to run,
//     which the atomic route's are not.
//   * Ids below 0 sort first and ids at or above S sort last: their values
//     are masked to 0 and their runs are never written.  With ids that are
//     not sorted the route writes only inside the output and its scratch,
//     and ends, but the sums are undefined.
//
// atomic (ids in any order; the JAX contract's general case): one block of
// 8 warps per (rank, tile of 8192 rows); each warp walks 1024 consecutive
// rows in groups of 32, a segmented scan over lanes (__shfl_up_sync) gives
// the last lane of each run its total, a run still open at lane 31 is
// carried into the next group, and a run's total goes out with one
// atomicAdd into `out`, which the launcher zero-fills first.  Float sums
// are added in atomic order across warps, so the last bits may differ from
// run to run.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------------
// atomic route
// ------------------------------------------------------------------------
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 1024;
constexpr int kTileRows = kWarps * kRowsPerWarp;
// id of the lanes past the end of a rank, and of "no open run"
constexpr int kNone = INT_MIN;

__device__ __forceinline__ void atomic_add(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(double* p, double v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(int* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(long long* p, long long v) {
  // two's complement: unsigned addition is signed addition modulo 2^64
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

template <typename T>
__device__ __forceinline__ void flush(T* out, int id, T total, int S, int C,
                                      int c) {
  if (id >= 0 && id < S) atomic_add(out + (int64_t)id * C + c, total);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
segsum_kernel(const int* __restrict__ seg, const T* __restrict__ val,
              T* __restrict__ out, int n, int S, int C) {
  const int rank = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int64_t lo = (int64_t)blockIdx.x * kTileRows +
                     (int64_t)(threadIdx.x >> 5) * kRowsPerWarp;
  if (lo >= n) return;  // the same in every lane of the warp
  const int64_t hi = lo + kRowsPerWarp < n ? lo + kRowsPerWarp : n;
  const int* s = seg + (int64_t)rank * n;
  const T* v = val + (int64_t)rank * n * C;
  T* o = out + (int64_t)rank * S * C;
  for (int c = 0; c < C; ++c) {
    T carry = T(0);
    int carry_id = kNone;
    for (int64_t base = lo; base < hi; base += 32) {
      const int64_t i = base + lane;
      const bool in = i < hi;
      const int id = in ? s[i] : kNone;
      T x = in ? v[i * C + c] : T(0);
      int prev = __shfl_up_sync(kFull, id, 1);
      if (lane == 0) prev = carry_id;
      const bool head = id != prev;
      // lane where this lane's run starts within the group
      int start = head ? lane : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFull, start, off);
        if (lane >= off && up > start) start = up;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const T up = __shfl_up_sync(kFull, x, off);
        if (lane - off >= start) x += up;
      }
      // the run at lane 0 continues the carried run unless lane 0 is a head
      const bool head0 = __shfl_sync(kFull, (int)head, 0) != 0;
      if (start == 0 && !head0) x += carry;
      const int next = __shfl_down_sync(kFull, id, 1);
      const bool tail = lane == 31 || next != id;
      if (lane == 0 && head0) flush(o, carry_id, carry, S, C, c);
      if (tail && lane != 31) flush(o, id, x, S, C, c);
      carry = __shfl_sync(kFull, x, 31);
      carry_id = __shfl_sync(kFull, id, 31);
    }
    if (lane == 0) flush(o, carry_id, carry, S, C, c);
  }
}

template <typename T>
int launch_atomic(const int* seg, const void* val, void* out, int p, int n,
                  int S, int C, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(T) * (size_t)p * S * C,
                                    stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + (int64_t)kTileRows - 1) / kTileRows),
                  (unsigned)p);
  segsum_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      seg, static_cast<const T*>(val), static_cast<T*>(out), n, S, C);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// sorted route
// ------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarpsPerTile = kThreads / 32;
constexpr int kPieceSlots = 2048;  // slots per piece of the long-gap list
constexpr int kListMin = 64;        // shortest gap put on the list
constexpr int kFillBlocks = 528;    // the fill launch's fixed grid
constexpr int kLookItems = 4;       // predecessors a thread reads a round
constexpr unsigned kAggregate = 1u;
constexpr unsigned kInclusive = 2u;

// rows per thread: 16 of 4-byte values, 8 of 8-byte ones (shared memory
// and registers stay about the same)
template <typename T>
struct Items {
  static constexpr int value = sizeof(T) == 4 ? 16 : 8;
};

// One pad element after every 128 bytes: a thread's consecutive rows then
// lie in distinct banks across the warp, and so do warp-striped stores.
__device__ __forceinline__ int pad_id(int i) { return i + (i >> 5); }
template <typename T>
__device__ __forceinline__ int pad_val(int i) {
  return i + i / (128 / (int)sizeof(T));
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned to_bits(int v) { return (unsigned)v; }
template <typename T>
__device__ __forceinline__ T from_bits(unsigned b);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}
template <>
__device__ __forceinline__ int from_bits<int>(unsigned b) {
  return (int)b;
}

// Partials of other tiles, read after their flag was acquired: strong
// loads at gpu scope, never a stale L1 line.
__device__ __forceinline__ float load_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ double load_relaxed(const double* p) {
  double v;
  asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];" : "=d"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ long long load_relaxed(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.s64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The scratch of one call, carved by the launcher (sorted_layout).
template <typename T>
struct Scratch {
  unsigned* flag;      // (p, C, tiles) status flags, zeroed
  // the same zeroed bytes as (p, C, tiles) packed status words: flag in
  // the high half, the partial's bits in the low half (4-byte values)
  unsigned long long* word;
  unsigned* ticket;    // zeroed
  unsigned* count;     // pieces on the list, zeroed
  T* part;             // (p, C, tiles) published partials
  T* first;            // (p, C, tiles) a tile's own part of slot lo
  long long* list;     // (cap, 2) pieces: first element, elements
  int cap;
};

// Slot s of a rank whose slot 0 has flat index rb, rounded down / up to a
// unit of k slots aligned in the flattened output.
__device__ __forceinline__ int floor_unit(int64_t rb, int s, int k) {
  return (int)((rb + s) / k * k - rb);
}
__device__ __forceinline__ int ceil_unit(int64_t rb, int s, int k) {
  return (int)((rb + s + k - 1) / k * k - rb);
}

// Pieces of kPieceSlots slots or fewer that slots [a, b) are cut into.
__device__ __forceinline__ int pieces_of(int a, int b) {
  return (b - a + kPieceSlots - 1) / kPieceSlots;
}

// Writes piece k of slots [a, b) of `rank` at list index `at`.
__device__ __forceinline__ void list_piece(long long* list, int cap,
                                           unsigned at, int rank, int S,
                                           int C, int a, int b, int k) {
  if (at >= (unsigned)cap) return;  // the bound in sorted_layout
  const int s = a + k * kPieceSlots;
  const int e = b - s > kPieceSlots ? s + kPieceSlots : b;
  list[2 * (int64_t)at] = ((int64_t)rank * S + s) * C;
  list[2 * (int64_t)at + 1] = (int64_t)(e - s) * C;
}

// Each lane's gap [a, b) (none where !has) onto the list at this lane's
// index `at`, which moves past it: a one-piece gap by its lane, a longer
// one by the whole warp, a piece a lane.
__device__ __forceinline__ void list_gaps(long long* list, int cap,
                                          unsigned& at, int rank, int S,
                                          int C, bool has, int a, int b) {
  const int lane = threadIdx.x & 31;
  const int np = has ? pieces_of(a, b) : 0;
  if (np == 1) list_piece(list, cap, at, rank, S, C, a, b, 0);
  unsigned big = __ballot_sync(kFull, np > 1);
  while (big) {
    const int src = __ffs(big) - 1;
    big &= big - 1;
    const int ga = __shfl_sync(kFull, a, src);
    const int gb = __shfl_sync(kFull, b, src);
    const unsigned g0 = __shfl_sync(kFull, at, src);
    for (int k = lane; k < pieces_of(ga, gb); k += 32)
      list_piece(list, cap, g0 + k, rank, S, C, ga, gb, k);
  }
  at += np;
}

// Shared memory of one tile: the warp-striped load staging (4-byte loads
// only), reused afterwards for each warp's part: its run ends, or the span
// of slots it stages.
template <typename T>
struct Smem {
  static constexpr int kItems = Items<T>::value;
  static constexpr int kRows = kThreads * kItems;
  static constexpr int kIds = kRows + kRows / 32;                  // padded
  static constexpr int kVals = kRows + kRows / (128 / sizeof(T)) + 2;
  static constexpr int kStage = kIds * 4 + kVals * (int)sizeof(T);
  static constexpr int kEnds = 32 * kItems;  // run ends a warp can hold
  static constexpr int kEndIds = kEnds + kEnds / 32 + 2;
  static constexpr int kEndVals = kEnds + kEnds / (128 / sizeof(T)) + 2;
  // slots a warp stages at once (padded)
  static constexpr int kWarpStage = sizeof(T) == 4 ? 1024 : 512;
  static constexpr int kSpan =
      (kWarpStage + kWarpStage / (128 / sizeof(T)) + 2) * (int)sizeof(T);
  static constexpr int kRunEnds = kEndIds * 4 + kEndVals * (int)sizeof(T);
  static constexpr int kWarp = kSpan > kRunEnds ? kSpan : kRunEnds;
  static constexpr int kBytes =
      kStage > kWarpsPerTile * kWarp ? kStage : kWarpsPerTile * kWarp;
};

// Steps 7 and 8 of segsum_sorted for a warp whose slots [wlo, whi) pass
// its shared memory: e_id / e_val hold its `total` run ends in id order.
// Not inlined, so that its registers do not press on the streaming part.
template <typename T>
__device__ __noinline__ void long_span(const int* e_id, const T* e_val,
                                       int total, int wlo, int whi, int lo,
                                       bool deferred, int rank, int S, int C,
                                       int c, T* out_g, T* first,
                                       unsigned* count, long long* list,
                                       int cap) {
  constexpr int kItems = Items<T>::value;
  const int lane = threadIdx.x & 31;
  // 7. a longer span goes out by units of kSec slots, aligned in the
  // flattened output (one 32-byte sector a unit when C == 1), so that no
  // sector is written in two parts: a unit holding run ends by the lane
  // of its first one, sums and zeros at once; the units without one, in
  // the regions before the first run end's unit, between two run ends'
  // units and after the last one, by the lane of the run end before
  // them (the region before the first by lane 0).  A region's whole
  // units go on the long-gap list when there are kListMin slots of them
  // or more, one atomic a warp.
  constexpr int kSec = 32 / (int)sizeof(T);
  const int64_t rb = (int64_t)rank * S;  // flat index of the rank's slot 0
  auto floor_u = [&](int sl) { return floor_unit(rb, sl, kSec); };
  auto ceil_u = [&](int sl) { return ceil_unit(rb, sl, kSec); };
  // the region after run end i's unit, [ra, rz) (empty unless the unit
  // holds no later run end), or with i = -1 the one before the first
  auto region = [&](int i, int& ra, int& rz) {
    if (i < 0) {  // before the first run end's unit
      ra = wlo;
      rz = total > 0 ? max(wlo, floor_u(e_id[pad_id(0)])) : whi;
      return;
    }
    const int e = e_id[pad_id(i)];
    const int u1 = floor_u(e) + kSec;
    const bool last = i + 1 == total || e_id[pad_id(i + 1)] >= u1;
    ra = u1;
    rz = !last ? u1 : (i + 1 < total ? floor_u(e_id[pad_id(i + 1)]) : whi);
  };
  auto listed = [&](int ra, int rz) {
    return ra < rz && floor_u(rz) - ceil_u(ra) >= kListMin;
  };
  if (c == 0) {
    int mine = 0;
    int ra, rz;
    if (lane == 0) {
      region(-1, ra, rz);
      if (listed(ra, rz)) mine += pieces_of(ceil_u(ra), floor_u(rz));
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = 32 * j + lane;
      if (i < total) {
        region(i, ra, rz);
        if (listed(ra, rz)) mine += pieces_of(ceil_u(ra), floor_u(rz));
      }
    }
    int at = mine;  // inclusive prefix of pieces over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(kFull, at, off);
      if (lane >= off) at += up;
    }
    const int all = __shfl_sync(kFull, at, 31);
    unsigned base = 0;
    if (lane == 0 && all > 0) base = atomicAdd(count, (unsigned)all);
    base = __shfl_sync(kFull, base, 0) + (unsigned)(at - mine);
    if (all > 0) {  // the same in the whole warp
      region(-1, ra, rz);
      const bool lead = lane == 0 && listed(ra, rz);
      list_gaps(list, cap, base, rank, S, C, lead, ceil_u(ra), floor_u(rz));
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = 32 * j + lane;
        ra = rz = 0;
        if (i < total) region(i, ra, rz);
        list_gaps(list, cap, base, rank, S, C, i < total && listed(ra, rz),
                  ceil_u(ra), floor_u(rz));
      }
    }
  }
  // 8. the writes: units with run ends, then the regions' slots that are
  // not on the list (whole units with 16-byte stores when C == 1)
  auto put = [&](int sl, T w) {
    if (deferred && sl == lo)
      *first = w;
    else
      out_g[(int64_t)sl * C + c] = w;
  };
  auto zero_slots = [&](int from, int to) {
    for (int sl = from; sl < to; ++sl) put(sl, T(0));
  };
  auto zero_region = [&](int ra, int rz) {
    const int fa = ceil_u(ra), fz = floor_u(rz);
    if (ra >= rz) return;
    if (fa >= fz) {
      zero_slots(ra, rz);
      return;
    }
    zero_slots(ra, fa);
    if (fz - fa < kListMin) {
      if (C == 1) {  // no slot lo here: it ends a run
        uint4* v = reinterpret_cast<uint4*>(out_g + fa);
        for (int k = 0; k < (fz - fa) / (16 / (int)sizeof(T)); ++k)
          v[k] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        zero_slots(fa, fz);
      }
    }
    zero_slots(fz, rz);
  };
  if (lane == 0) {
    int ra, rz;
    region(-1, ra, rz);
    zero_region(ra, rz);
  }
  for (int i = lane; i < total; i += 32) {
    const int e = e_id[pad_id(i)];
    const int u0 = floor_u(e);
    if (i == 0 || e_id[pad_id(i - 1)] < u0) {
      // the first run end of its unit: the unit's slots in the span
      const int ua = max(u0, wlo), uz = min(u0 + kSec, whi);
      int j = i;
      if (C == 1 && ua == u0 && uz == u0 + kSec &&
          !(deferred && lo >= ua && lo < uz)) {
        union {
          uint4 q[2];
          T t[kSec];
        } w;
#pragma unroll
        for (int k = 0; k < kSec; ++k) {
          const bool hit = j < total && e_id[pad_id(j)] == u0 + k;
          w.t[k] = hit ? e_val[pad_val<T>(j)] : T(0);
          j += hit;
        }
        uint4* v = reinterpret_cast<uint4*>(out_g + u0);
        v[0] = w.q[0];
        v[1] = w.q[1];
      } else {
        for (int sl = ua; sl < uz; ++sl) {
          const bool hit = j < total && e_id[pad_id(j)] == sl;
          put(sl, hit ? e_val[pad_val<T>(j)] : T(0));
          j += hit;
        }
      }
    }
    int ra, rz;
    region(i, ra, rz);
    zero_region(ra, rz);
  }
  __syncwarp();
}

template <typename T, bool kVec, bool kPack>
__global__ void __launch_bounds__(kThreads, 3)
segsum_sorted(const int* __restrict__ seg, const T* __restrict__ val,
              T* __restrict__ out, Scratch<T> sc, int p, int n, int S, int C,
              int tiles) {
  using M = Smem<T>;
  constexpr int kItems = M::kItems;
  constexpr int kRows = M::kRows;
  constexpr int kPerVec = 16 / (int)sizeof(T);  // values a 16-byte load
  static_assert(M::kIds % 2 == 0 && M::kEndIds % 2 == 0 &&
                M::kEndVals % 2 == 0, "8-byte alignment of the parts");
  __shared__ __align__(16) unsigned char s_raw[M::kBytes];
  __shared__ T s_wv[kWarpsPerTile];
  __shared__ int s_wf[kWarpsPerTile];
  __shared__ unsigned s_ticket;
  __shared__ int s_k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(sc.ticket, 1u);
  __syncthreads();
  // ticket t: column t % C of tile t / C / p of rank t / C % p, so the
  // C blocks of a tile run side by side and share its lines in L2
  const int c = (int)(s_ticket % (unsigned)C);
  const int rank = (int)(s_ticket / (unsigned)C % (unsigned)p);
  const int tile = (int)(s_ticket / (unsigned)C / (unsigned)p);
  const int64_t row0 = (int64_t)tile * kRows;
  const int rows = n - row0 < kRows ? (int)(n - row0) : kRows;
  const bool last = tile == tiles - 1;
  const int* ids_g = seg + (int64_t)rank * n + row0;
  const T* val_g = val + ((int64_t)rank * n + row0) * C + c;
  T* out_g = out + (int64_t)rank * S * C;
  // status index: a look-back chain per (rank, column)
  const int64_t st = ((int64_t)rank * C + c) * tiles + tile;
  // the row before the tile, the tile's last row and the next tile's first
  // (a tile is full unless it is the rank's last)
  const int prev = tile > 0 ? __ldg(ids_g - 1) : INT_MIN;
  const int lastid = last ? INT_MAX : __ldg(ids_g + kRows - 1);
  const int nextid = last ? INT_MAX : __ldg(ids_g + kRows);

  // 1. this thread's consecutive rows into registers: ids, and column c's
  // values; rows past the rank's end take id INT_MAX (at or above
  // S, so never written) and value 0
  int id[kItems];
  T x[kItems];
  const int mine0 = tid * kItems;  // the thread's first row in the tile
  int* s_ids = reinterpret_cast<int*>(s_raw);
  T* s_val = reinterpret_cast<T*>(s_raw + M::kIds * 4);
  if (kVec) {  // C == 1, rows a multiple of 4: 16-byte loads, read once
    const int4* src = reinterpret_cast<const int4*>(ids_g + mine0);
    const uint4* vsrc = reinterpret_cast<const uint4*>(val_g + mine0);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int4 w = mine0 + 4 * k < rows
                         ? __ldg(src + k)
                         : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
      id[4 * k] = w.x;
      id[4 * k + 1] = w.y;
      id[4 * k + 2] = w.z;
      id[4 * k + 3] = w.w;
    }
#pragma unroll
    for (int k = 0; k < kItems / kPerVec; ++k) {
      union {
        uint4 u;
        T t[kPerVec];
      } e;
      e.u = mine0 + kPerVec * k < rows ? __ldg(vsrc + k)
                                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < kPerVec; ++j) x[kPerVec * k + j] = e.t[j];
    }
  } else {  // warp-striped 4-byte loads through shared memory
    int w[kItems];
    T v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + tid;
      w[k] = i < rows ? __ldcs(ids_g + i) : INT_MAX;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + tid;
      v[k] = i < rows ? val_g[(int64_t)i * C] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + tid;
      s_ids[pad_id(i)] = w[k];
      s_val[pad_val<T>(i)] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      id[k] = s_ids[pad_id(mine0 + k)];
      x[k] = s_val[pad_val<T>(mine0 + k)];
    }
  }

  // 2. where each run ends (bit k: row k's id differs from the next
  // row's; after a rank's last row comes INT_MAX).  A run that goes on
  // into the next tile is the tile's open run.
  int nxt = __shfl_down_sync(kFull, id[0], 1);
  if (lane == 31)
    nxt = mine0 + kItems < rows ? __ldg(ids_g + mine0 + kItems)
                                : (tid == kThreads - 1 ? nextid : INT_MAX);
  unsigned ends = 0;
#pragma unroll
  for (int k = 0; k + 1 < kItems; ++k)
    if (id[k] != id[k + 1]) ends |= 1u << k;
  if (id[kItems - 1] != nxt) ends |= 1u << (kItems - 1);
  // Slot s belongs to the tile (and in it to the warp) holding the last
  // row with id <= s: the run's own slot where the run ends, and the gap
  // after it.  The tile's slots are [lo, hi); slot lo waits for the carry
  // when the tile's first run began in an earlier tile.
  auto clip = [S](int v) { return v < 0 ? 0 : (v < S ? v : S); };
  const int lo = tile == 0 ? 0 : clip(__ldg(ids_g));
  const int hi = last ? S : clip(nextid);
  const bool prev_in = prev >= 0 && prev < S;
  const bool deferred = prev_in && prev == lo && lo < hi;
  // the whole tile is one run, begun before it and going on after it
  const bool continuing = !last && prev_in && lastid == prev &&
                          nextid == lastid;
  // this warp's part: from its first row's id to the next warp's
  const int wa = warp == 0 ? lo : clip(__shfl_sync(kFull, id[0], 0));
  const int wnext = __shfl_sync(kFull, nxt, 31);
  const int wb = warp == kWarpsPerTile - 1 ? hi : clip(wnext);
  const int wlo = wa < lo ? lo : (wa > hi ? hi : wa);
  const int whi = wb < wlo ? wlo : (wb > hi ? hi : wb);
  unsigned long long window = 0;  // predecessors' packed status words
  {
    // 3. the thread's rows summed by run: x[k] is the run's sum from its
    // first row in this thread up to row k
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (id[k] < 0 || id[k] >= S) x[k] = T(0);
#pragma unroll
    for (int k = 1; k < kItems; ++k)
      if (!((ends >> (k - 1)) & 1u)) x[k] = x[k - 1] + x[k];
    // 4. block-wide segmented scan of (ends a run, open run's sum)
    int f = ends != 0;
    T v = (ends >> (kItems - 1)) & 1u ? T(0) : x[kItems - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int fu = __shfl_up_sync(kFull, f, off);
      const T vu = __shfl_up_sync(kFull, v, off);
      if (lane >= off) {
        if (!f) v = vu + v;
        f |= fu;
      }
    }
    if (lane == 31) {
      s_wf[warp] = f;
      s_wv[warp] = v;
    }
    __syncthreads();
    int pf = 0;
    T pv = T(0);  // earlier warps, folded in warp order
    for (int k = 0; k < warp; ++k) {
      pv = s_wf[k] ? s_wv[k] : pv + s_wv[k];
      pf |= s_wf[k];
    }
    const T bv = f ? v : pv + v;  // inclusive of this thread
    T carry = __shfl_up_sync(kFull, bv, 1);
    if (lane == 0) carry = pv;
    // 5. publish the tile's open run, once: inclusive when it starts in
    // this tile, else an aggregate
    if (tid == kThreads - 1 && !last) {
      const unsigned kind = continuing ? kAggregate : kInclusive;
      if constexpr (kPack) {
        store_word(sc.word + st,
                   (unsigned long long)kind << 32 | to_bits(bv));
      } else {
        sc.part[st] = bv;
        store_release(sc.flag + st, kind);
      }
    }
    if constexpr (kPack) {  // the look-back's first read, in flight early
      if (warp == 0 && deferred && lane < tile)
        window = load_word(sc.word + st - 1 - lane);
    }
    // 6. this warp's runs ending in [lo, hi): staged at once when they lie
    // in a short stretch of its slots, else their ids and sums into its
    // shared memory in id order (a thread's first run began in earlier
    // threads of the tile)
    unsigned char* wbase = s_raw + warp * M::kWarp;
    int* e_id = reinterpret_cast<int*>(wbase);
    T* e_val = reinterpret_cast<T*>(wbase + M::kEndIds * 4);
    int cnt = 0, mine_end = wlo;  // past this lane's last run end
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool in = ((ends >> k) & 1u) && id[k] >= lo && id[k] < hi;
      cnt += in;
      if (in) mine_end = id[k] + 1;
    }
    int at = cnt;  // inclusive prefix over the warp's lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(kFull, at, off);
      if (lane >= off) at += up;
    }
    const int total = __shfl_sync(kFull, at, 31);
    at -= cnt;
    // the staged stretch [wlo, sz): up to the unit after the last run end
    constexpr int kSec = 32 / (int)sizeof(T);
    const int64_t rb = (int64_t)rank * S;
    int sz = ceil_unit(rb, __reduce_max_sync(kFull, mine_end), kSec);
    sz = sz < whi ? sz : whi;
    if (sz - wlo <= M::kWarpStage) {
      // run ends in a stretch that fits the warp's shared memory (the
      // groupby's ids count up by one): sums scattered from registers into
      // it, zeros first only where some slot has no run, out in whole
      // sectors; the slots after it, [sz, whi), hold no run end: their
      // whole units go on the long-gap list when there are kListMin slots
      // of them or more (the padding's gap at the last valid group)
      const int fz = floor_unit(rb, whi, kSec);
      if (fz - sz >= kListMin) {
        if (c == 0) {
          const int np = pieces_of(sz, fz);
          unsigned base = 0;
          if (lane == 0) base = atomicAdd(sc.count, (unsigned)np);
          base = __shfl_sync(kFull, base, 0);
          for (int k = lane; k < np; k += 32)
            list_piece(sc.list, sc.cap, base + k, rank, S, C, sz, fz, k);
        }
        for (int sl = fz + lane; sl < whi; sl += 32)
          out_g[(int64_t)sl * C + c] = T(0);
      } else {
        for (int sl = sz + lane; sl < whi; sl += 32)
          out_g[(int64_t)sl * C + c] = T(0);
      }
      T* stage = reinterpret_cast<T*>(wbase);
      const int len = sz - wlo;
      if (total < len)
        for (int j = lane; j < len; j += 32) stage[pad_val<T>(j)] = T(0);
      __syncwarp();
      bool head = true;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if ((ends >> k) & 1u) {
          const T sum = head ? carry + x[k] : x[k];
          head = false;
          if (id[k] >= lo && id[k] < hi) stage[pad_val<T>(id[k] - wlo)] = sum;
        }
      }
      __syncwarp();
      for (int j = lane; j < len; j += 32) {
        const T w = stage[pad_val<T>(j)];
        if (deferred && wlo + j == lo)
          sc.first[st] = w;
        else
          out_g[(int64_t)(wlo + j) * C + c] = w;
      }
      __syncwarp();
    } else {
      bool first = true;
  #pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if ((ends >> k) & 1u) {
          const T sum = first ? carry + x[k] : x[k];
          first = false;
          if (id[k] >= lo && id[k] < hi) {
            e_id[pad_id(at)] = id[k];
            e_val[pad_val<T>(at)] = sum;
            ++at;
          }
        }
      }
      __syncwarp();
      // 7.-8. a longer span (long_span)
      long_span<T>(e_id, e_val, total, wlo, whi, lo, deferred, rank, S, C, c,
                   out_g, sc.first + st, sc.count, sc.list, sc.cap);
    }
  }

  // 9. look-back, by the tile in which the run continuing into it ends:
  // slot lo takes the tile's own part (in `first`) plus the predecessors'
  // partials from the nearest inclusive one on.  Round 0, by warp 0 alone,
  // reads the 32 nearest predecessors until one is inclusive with every
  // nearer one published, or all are aggregates; then the whole block
  // reads kRound more a round, again until its nearest inclusive partial
  // has every nearer one published.  Each round is summed by a fixed tree
  // and added to `first` in round order.
  if (!deferred) return;  // the same in the whole block
  constexpr int kRound = kLookItems * kThreads;
  T* acc = sc.first + st;
  T* s_sum = reinterpret_cast<T*>(s_raw);
  __shared__ int s_open;  // round 0 found no inclusive partial
  __syncthreads();        // `first` written, shared memory free
  if (warp == 0) {
    unsigned long long wd = window;  // packed word, or flag
    if constexpr (!kPack) {
      if (lane < tile)
        wd = (unsigned long long)load_acquire(sc.flag + st - 1 - lane) << 32;
    }
    int k = -1;
    while (true) {
      const unsigned fl = (unsigned)(wd >> 32);
      const unsigned inc = __ballot_sync(kFull, fl == kInclusive);
      const unsigned none = __ballot_sync(kFull, fl == 0u && lane < tile);
      if (inc) {
        k = __ffs(inc) - 1;
        if ((none & ((1u << k) - 1u)) == 0u) break;
      } else if (!none) {
        break;  // 32 aggregates: the run began further back
      }
      if (lane < tile) {
        if constexpr (kPack)
          wd = load_word(sc.word + st - 1 - lane);
        else
          wd = (unsigned long long)load_acquire(sc.flag + st - 1 - lane)
               << 32;
      }
    }
    T v = T(0);
    if (lane < tile && (k < 0 || lane <= k)) {
      if constexpr (kPack)
        v = from_bits<T>((unsigned)wd);
      else
        v = load_relaxed(sc.part + (st - 1 - lane));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = v + __shfl_xor_sync(kFull, v, off);
    if (lane == 0) {
      *acc = *acc + v;
      if (k >= 0) out_g[(int64_t)lo * C + c] = *acc;
      s_open = k < 0;
    }
  }
  __syncthreads();
  if (!s_open) return;  // the same in the whole block
  for (int base = 32;; base += kRound) {
    unsigned long long wd[kLookItems];  // packed words, or flags
    int kmin;
    while (true) {
      int mine = INT_MAX;
      bool wait = false;
#pragma unroll
      for (int u = 0; u < kLookItems; ++u) {
        const int d = base + u * kThreads + tid;
        if (d >= tile)
          wd[u] = (unsigned long long)kAggregate << 32;
        else if constexpr (kPack)
          wd[u] = load_word(sc.word + st - 1 - d);
        else
          wd[u] = (unsigned long long)load_acquire(sc.flag + st - 1 - d)
                  << 32;
        const unsigned fl = (unsigned)(wd[u] >> 32);
        if (fl == kInclusive && d < mine) mine = d;
      }
      if (tid == 0) s_k = INT_MAX;
      __syncthreads();
      if (mine != INT_MAX) atomicMin(&s_k, mine);
      __syncthreads();
      kmin = s_k;
#pragma unroll
      for (int u = 0; u < kLookItems; ++u) {
        const int d = base + u * kThreads + tid;
        if (d < kmin && (unsigned)(wd[u] >> 32) == 0u) wait = true;
      }
      if (!__syncthreads_or(wait)) break;
    }
    T v = T(0);
#pragma unroll
    for (int u = 0; u < kLookItems; ++u) {
      const int d = base + u * kThreads + tid;
      if (d < tile && d <= kmin) {
        if constexpr (kPack)
          v = v + from_bits<T>((unsigned)wd[u]);
        else
          v = v + load_relaxed(sc.part + (st - 1 - d));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = v + __shfl_xor_sync(kFull, v, off);
    if (lane == 0) s_sum[warp] = v;
    __syncthreads();
    if (tid == 0) {
      T t = *acc;
      for (int w = 0; w < kWarpsPerTile; ++w) t = t + s_sum[w];
      *acc = t;
    }
    __syncthreads();
    if (kmin < base + kRound) break;  // the same in the whole block
  }
  if (tid == 0) out_g[(int64_t)lo * C + c] = *acc;
}

// Zero-fills the long-gap list's pieces; the grid is fixed and the list's
// length is read here, on the device, once a block.  Warp w of W takes
// pieces w, w + W, w + 2 W, ... (the pieces of one long gap lie side by
// side in the list, so they spread over the warps), loads up to 32 of them
// at once (one a lane) and fills them one after another with all its
// lanes: 4-byte words up to a 16-byte boundary, 16-byte stores, the rest.
__global__ void __launch_bounds__(kThreads)
segsum_fill(const long long* __restrict__ list,
            const unsigned* __restrict__ count, void* out, int elem_bytes,
            int cap) {
  __shared__ unsigned s_n;
  if (threadIdx.x == 0) s_n = *count < (unsigned)cap ? *count : (unsigned)cap;
  __syncthreads();
  const unsigned n = s_n;
  unsigned* words = static_cast<unsigned*>(out);
  const int per = elem_bytes / 4, lane = threadIdx.x & 31;
  const unsigned warps = gridDim.x * (kThreads / 32);
  const unsigned w = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  for (uint64_t b0 = w; b0 < n; b0 += 32 * (uint64_t)warps) {
    const uint64_t e = b0 + (uint64_t)lane * warps;
    const long long s0 = e < n ? list[2 * (int64_t)e] : 0;
    const long long l0 = e < n ? list[2 * (int64_t)e + 1] : 0;
    const int pieces = __popc(__ballot_sync(kFull, e < n));  // a prefix
    for (int u = 0; u < pieces; ++u) {
      const int64_t w0 = __shfl_sync(kFull, s0, u) * per;
      const int64_t nw = __shfl_sync(kFull, l0, u) * per;
      const int mis =
          (int)((reinterpret_cast<uintptr_t>(words + w0) >> 2) & 3);
      const int64_t head = mis ? (4 - mis < nw ? 4 - mis : nw) : 0;
      const int64_t body = (nw - head) / 4;
      if (lane < head) words[w0 + lane] = 0u;
      uint4* vec = reinterpret_cast<uint4*>(words + w0 + head);
      for (int64_t i = lane; i < body; i += 32)
        vec[i] = make_uint4(0u, 0u, 0u, 0u);
      for (int64_t i = head + 4 * body + lane; i < nw; i += 32)
        words[w0 + i] = 0u;
    }
  }
}

// Scratch of one sorted call, in bytes, and its parts.
struct Layout {
  int tiles, cap;
  size_t zeroed;  // flags, ticket and count: zeroed before each launch
  size_t part, first, list, total;
};

Layout sorted_layout(int p, int n, int S, int C, int value_bytes) {
  Layout l;
  const int rows = kThreads * (value_bytes == 4 ? Items<float>::value
                                                : Items<double>::value);
  l.tiles = (int)((n + (int64_t)rows - 1) / rows);
  // a status word, a partial and a first slot's part per (rank, column,
  // tile)
  const size_t words = (size_t)p * C * l.tiles;
  const size_t parts = words * value_bytes;
  // a listed gap has kListMin slots or more and lies before a run end or
  // after a warp's last one: at most min(S / kListMin, n + warps) gaps and
  // S / kPieceSlots extra pieces per rank
  const int64_t gaps = (S + (int64_t)kListMin - 1) / kListMin;
  const int64_t ends = (int64_t)n + (int64_t)l.tiles * kWarpsPerTile;
  const int64_t cap = (int64_t)p * ((gaps < ends ? gaps : ends) +
                                    (S + (int64_t)kPieceSlots - 1) /
                                        kPieceSlots + 1);
  l.cap = cap > 0x7fffffff ? -1 : (int)cap;
  l.zeroed = (words * sizeof(unsigned long long) + 2 * sizeof(unsigned) +
              15) / 16 * 16;
  l.part = l.zeroed;
  l.first = l.part + (parts + 15) / 16 * 16;
  l.list = l.first + (parts + 15) / 16 * 16;
  l.total = l.list + (size_t)l.cap * 2 * sizeof(long long);
  return l;
}

template <typename T>
int launch_sorted(const int* seg, const void* val, void* out, void* scratch,
                  int p, int n, int S, int C, cudaStream_t stream) {
  const Layout l = sorted_layout(p, n, S, C, (int)sizeof(T));
  if (l.cap < 0) return cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  Scratch<T> sc;
  sc.flag = reinterpret_cast<unsigned*>(base);
  sc.word = reinterpret_cast<unsigned long long*>(base);
  sc.ticket = reinterpret_cast<unsigned*>(sc.word + (size_t)p * C * l.tiles);
  sc.count = sc.ticket + 1;
  sc.part = reinterpret_cast<T*>(base + l.part);
  sc.first = reinterpret_cast<T*>(base + l.first);
  sc.list = reinterpret_cast<long long*>(base + l.list);
  sc.cap = l.cap;
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.zeroed, stream);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)p * C * l.tiles;  // a column of a tile
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const bool vec = C == 1 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(seg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(val) % 16 == 0;
  const T* v = static_cast<const T*>(val);
  T* o = static_cast<T*>(out);
  // one packed status word (flag and partial) for 4-byte values
  constexpr bool kPack = sizeof(T) == 4;
  if (vec)
    segsum_sorted<T, true, kPack><<<(unsigned)blocks, kThreads, 0, stream>>>(
        seg, v, o, sc, p, n, S, C, l.tiles);
  else
    segsum_sorted<T, false, kPack><<<(unsigned)blocks, kThreads, 0, stream>>>(
        seg, v, o, sc, p, n, S, C, l.tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a listed gap has kListMin slots or more
  if (S >= kListMin) {
    segsum_fill<<<kFillBlocks, kThreads, 0, stream>>>(
        sc.list, sc.count, out, (int)sizeof(T), l.cap);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 int32, 3 int64.  Needs p >= 1, n >= 1,
// S >= 1, C >= 1.

// atomic route: ids in any order.  Zero-fills `out` (p, S, C) and adds
// every row's values into it.  Returns 0 or the first CUDA error.  Launches
// on `stream`, does not synchronise.
extern "C" int segmented_sum_launch(const int* seg, const void* val,
                                    void* out, int p, int n, int S, int C,
                                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_atomic<float>(seg, val, out, p, n, S, C, st);
    case 1: return launch_atomic<double>(seg, val, out, p, n, S, C, st);
    case 2: return launch_atomic<int>(seg, val, out, p, n, S, C, st);
    case 3: return launch_atomic<long long>(seg, val, out, p, n, S, C, st);
    default: return cudaErrorInvalidValue;
  }
}

// sorted route: ids non-decreasing within each rank.  Writes every slot of
// `out` (p, S, C) once; `scratch` holds segmented_sum_sorted_scratch(...)
// bytes (its flags, ticket and list length are zeroed here).  Returns 0 or
// the first CUDA error.  Launches on `stream`, does not synchronise.
extern "C" int segmented_sum_sorted(const int* seg, const void* val,
                                    void* out, void* scratch, int p, int n,
                                    int S, int C, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_sorted<float>(seg, val, out, scratch, p, n, S, C,
                                        st);
    case 1: return launch_sorted<double>(seg, val, out, scratch, p, n, S, C,
                                         st);
    case 2: return launch_sorted<int>(seg, val, out, scratch, p, n, S, C,
                                      st);
    case 3: return launch_sorted<long long>(seg, val, out, scratch, p, n, S,
                                            C, st);
    default: return cudaErrorInvalidValue;
  }
}

// Bytes of scratch the sorted route needs for these sizes, or -1 where its
// long-gap list would pass 2**31 - 1 pieces.
extern "C" long long segmented_sum_sorted_scratch(int p, int n, int S, int C,
                                                  int dtype) {
  const Layout l = sorted_layout(p, n, S, C, dtype == 0 || dtype == 2 ? 4 : 8);
  return l.cap < 0 ? -1 : (long long)l.total;
}

// The sorted route's constants, for tests at its edges: rows per tile of
// 4-byte and of 8-byte values, slots per long-gap piece.
extern "C" void segmented_sum_constants(int* out) {
  out[0] = kThreads * Items<float>::value;
  out[1] = kThreads * Items<double>::value;
  out[2] = kPieceSlots;
}

extern "C" const char* segmented_sum_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
