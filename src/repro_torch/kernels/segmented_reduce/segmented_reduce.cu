// Segmented sum for Hopper (sm_90a): the groupby's sum, count and size.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segmented_reduce/segmented_reduce.py::segmented_sum_pallas
// (body `_kernel`, wrapper `ops.segmented_sum`).  For every rank r of p and
// every value column c of C it computes
//   out[r, s, c] = sum of values[r, i, c] over the rows i with seg[r, i] == s
// for s in [0, S); rows whose id lies outside [0, S) add nothing, as JAX
// drops out-of-range segment updates.
//
// What bounds it: bytes.  The function reads 4 bytes of id and C values per
// row and writes the (S, C) sums once; it does one addition per value.
//
// Design.  The TPU kernel turns each row block into a one-hot matrix and
// multiplies it on the MXU, with the output tile resident in VMEM across a
// sequential grid of row blocks.  Here blocks run in parallel and there is
// no resident output, so the kernel works on runs of equal ids instead:
//   * one block of 8 warps per (rank, tile of 8192 rows); each warp walks
//     1024 consecutive rows in groups of 32;
//   * in a group, a lane is a head where its id differs from the previous
//     row's; a max-scan over lanes (__shfl_up_sync) gives each lane the
//     start of its run, and a segmented inclusive sum scan adds only
//     within a run, so the last lane of a run holds the run's total;
//   * the run still open at lane 31 is carried in registers into the next
//     group, so a run longer than 32 rows costs no extra atomics;
//   * a run's total goes out with one atomicAdd to out[r, id, c], when
//     the id changes or the warp ends.
// The groupby hands the kernel ids sorted within each rank, with every
// padding row at id cap - 1: a warp then issues one atomic per distinct
// segment it touches, and the padding costs one atomic per warp rather
// than one per row.  Ids in any order stay correct; they only cost more
// atomics.  The launcher zero-fills `out` before the kernel runs.
// Float sums are added in scan order within a run and in atomic order
// across warps, so the last bits may differ from run to run.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
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
int launch(const int* seg, const void* val, void* out, int p, int n, int S,
           int C, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(T) * (size_t)p * S * C,
                                    stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + (int64_t)kTileRows - 1) / kTileRows),
                  (unsigned)p);
  segsum_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      seg, static_cast<const T*>(val), static_cast<T*>(out), n, S, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 int32, 3 int64.  Needs p >= 1, n >= 1,
// S >= 1, C >= 1.  Zero-fills `out` (p, S, C) and adds every row's values
// into it.  Returns 0 or the first CUDA error.  Launches on `stream`, does
// not synchronise.
extern "C" int segmented_sum_launch(const int* seg, const void* val,
                                    void* out, int p, int n, int S, int C,
                                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(seg, val, out, p, n, S, C, st);
    case 1: return launch<double>(seg, val, out, p, n, S, C, st);
    case 2: return launch<int>(seg, val, out, p, n, S, C, st);
    case 3: return launch<long long>(seg, val, out, p, n, S, C, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* segmented_sum_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
