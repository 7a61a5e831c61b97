// Z-run presence and rank: for every base query q of a (cloud, xy offset,
// output voxel), which of the kz consecutive packed keys [q, q + kz) are in
// the cloud's sorted key table (bit j set when q + j is present), and for the
// rank variant rank(q) = #keys < q.  MAXKEY queries are invalid: bits 0 and
// rank 0 (rank is only read where a bit is set).
//
// Replaces egonn_tpu/sparse/banded.py::_pallas_zrun_presence (wrapper
// zrun_presence, the stem's presence map) and ::_pallas_zrun_rank (wrapper
// zrun_rank, the 3^3 self maps), which compare every query against a band
// window of the table on the TPU's vector unit.
//
// A lower-bound search per query is a chain of 10-15 dependent loads: one
// thread per query through the global table leaves the call waiting on L2
// round trips.  But each (cloud, xy offset) row of queries is sorted over
// its valid entries (the voxels are key-sorted and an xy offset moves every
// key alike; pyramid.py::_zrun_queries), so a chunk of Q neighbouring
// queries needs about Q rows of the table.  Design: one block of 256
// threads per (chunk of Q queries, xy offset, cloud).
// 1. The chunk is read coalesced; a block reduction gives the min and max
//    of its valid queries.  A chunk without one writes zeros.
// 2. Every thread reads one of 256 evenly spaced table rows (step
//    ceil(C / 256)), and two block counts of the rows below the min and
//    below the max bound every rank of the chunk to [lo, hi]: lo within a
//    step below lower_bound(min), hi within a step above lower_bound(max).
//    One round trip to L2 instead of a binary search's ~14.
// 3. table[lo, min(hi + kz, C)) is copied into shared memory (room for
//    2Q + 2 steps + 8 rows); each query's rank is lo plus its lower bound
//    in the slice, by binary search in shared memory, and its bits come
//    from the next <= kz slice rows (keys are unique and sorted).  Writes
//    are coalesced.
// 4. A chunk whose slice does not fit (queries out of order or spread) runs
//    the per-query search in the global table, narrowed to [lo, hi]: exact
//    and slower; `overflow` counts such blocks.
// Correctness never depends on the queries being sorted; only speed does.
// Bound: the bytes of the queries, the outputs and the table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace egonn {

constexpr int32_t kMaxKey = 2147483647;
constexpr int kThreads = 256;
constexpr int kMaxChunk = 1024;  // queries per block, at most
constexpr int kPer = kMaxChunk / kThreads;

// first index in [lo, hi) with keys[i] >= q (hi if none), one thread
__device__ __forceinline__ int lower_bound(const int32_t* keys, int lo, int hi, int32_t q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// bit j of the result set when q + j is among keys[r .. n), r = rank(q)
__device__ __forceinline__ int run_bits(const int32_t* keys, int r, int n, int32_t q, int kz) {
  int m = 0;
  for (int j = 0; j < kz && r + j < n; ++j) {
    const long long d = (long long)keys[r + j] - q;
    if (d >= kz) break;
    m |= 1 << d;
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
zrun_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ q_lo,
            int32_t* __restrict__ bits, int32_t* __restrict__ rank, int* __restrict__ overflow,
            int c_in, int n_xy, int n_row, int q_chunk, int kz, int slice_cap) {
  extern __shared__ int32_t slice_s[];  // slice_cap rows of the table
  __shared__ int red_s[2][kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * q_chunk;
  const int n = min(q_chunk, n_row - c0);
  const size_t base = ((size_t)blockIdx.z * n_xy + blockIdx.y) * n_row + c0;
  const int32_t* kb = keys + (size_t)blockIdx.z * c_in;

  // 1. the chunk, and the min and max of its valid queries
  int32_t q[kPer];
  int qmin = kMaxKey, qmax = -kMaxKey - 1;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads;
    q[u] = i < n ? q_lo[base + i] : kMaxKey;
    if (q[u] != kMaxKey) {
      qmin = min(qmin, q[u]);
      qmax = max(qmax, q[u]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, d));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, d));
  }
  if (lane == 0) {
    red_s[0][warp] = qmin;
    red_s[1][warp] = qmax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    qmin = min(qmin, red_s[0][w]);
    qmax = max(qmax, red_s[1][w]);
  }
  if (qmin == kMaxKey) {  // no valid query
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads;
      if (i < n) {
        bits[base + i] = 0;
        if (rank) rank[base + i] = 0;
      }
    }
    return;
  }

  // 2. a probes below the min: lower_bound(min) >= min(a step, C); b below
  // the max: lower_bound(max) <= row b's index (C when b = 256)
  const int step = (c_in + kThreads - 1) / kThreads;
  const int32_t probe = __ldg(kb + min((tid + 1) * step - 1, c_in - 1));
  const int a = __syncthreads_count(probe < qmin);
  const int b = __syncthreads_count(probe < qmax);
  const int lo = min(a * step, c_in);
  const int hi = b < kThreads ? min((b + 1) * step - 1, c_in - 1) : c_in;
  const int n_slice = min(hi + kz, c_in) - lo;

  if (n_slice <= slice_cap) {
    // 3. the slice in shared memory
    for (int e = tid; e < n_slice; e += kThreads) slice_s[e] = __ldg(kb + lo + e);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads;
      if (i >= n) continue;
      int m = 0, r = 0;
      if (q[u] != kMaxKey) {
        r = lower_bound(slice_s, 0, hi - lo, q[u]);
        m = run_bits(slice_s, r, n_slice, q[u], kz);
        r += lo;
      }
      bits[base + i] = m;
      if (rank) rank[base + i] = r;
    }
    return;
  }
  // 4. the slice does not fit: each query searches the global table
  if (tid == 0 && overflow) atomicAdd(overflow, 1);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads;
    if (i >= n) continue;
    int m = 0, r = 0;
    if (q[u] != kMaxKey) {
      r = lower_bound(kb, lo, hi, q[u]);
      m = run_bits(kb, r, c_in, q[u], kz);
    }
    bits[base + i] = m;
    if (rank) rank[base + i] = r;
  }
}

// q_lo, bits, rank: (batch, n_xy, n_row); one block per q_chunk queries of
// a row (1 <= q_chunk <= 1024); overflow: an int the blocks whose slice did
// not fit are added to (or null).
int launch(const int32_t* keys, const int32_t* q_lo, int32_t* bits, int32_t* rank, int* overflow,
           int batch, int c_in, int n_xy, int n_row, int q_chunk, int kz, void* stream) {
  if (q_chunk < 1 || q_chunk > kMaxChunk || kz < 1 || kz > 8 || c_in < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_xy == 0 || n_row == 0) return (int)cudaSuccess;
  const dim3 grid((n_row + q_chunk - 1) / q_chunk, n_xy, batch);
  // 2Q rows of sorted queries' span, two probe steps of slack, kz rows past
  // the last rank; at most 48 KB (larger slices take the global path)
  const int step = (c_in + kThreads - 1) / kThreads;
  const int slice_cap = min(2 * q_chunk + 2 * step + 8, 12 * 1024);
  const size_t smem = sizeof(int32_t) * slice_cap;
  zrun_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, q_lo, bits, rank, overflow, c_in, n_xy, n_row, q_chunk, kz, slice_cap);
  return (int)cudaGetLastError();
}

}  // namespace egonn

extern "C" int egonn_zrun_presence(const int32_t* keys, const int32_t* q_lo, int32_t* bits,
                                   int* overflow, int batch, int c_in, int n_xy, int n_row,
                                   int q_chunk, int kz, void* stream) {
  return egonn::launch(keys, q_lo, bits, nullptr, overflow, batch, c_in, n_xy, n_row, q_chunk,
                       kz, stream);
}

extern "C" int egonn_zrun_rank(const int32_t* keys, const int32_t* q_lo, int32_t* bits,
                               int32_t* rank, int* overflow, int batch, int c_in, int n_xy,
                               int n_row, int q_chunk, int kz, void* stream) {
  return egonn::launch(keys, q_lo, bits, rank, overflow, batch, c_in, n_xy, n_row, q_chunk, kz,
                       stream);
}
