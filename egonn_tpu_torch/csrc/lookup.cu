// Sorted-key lookup: for every query of a (cloud, kernel offset, output
// voxel), its position in the cloud's sorted key table, or c_in where the key
// is absent or the query is MAXKEY (invalid).  Builds the k=2 s=2 down maps
// of levels whose finer level records no up map.
//
// Replaces egonn_tpu/sparse/banded.py::_pallas_banded_lookup (wrapper
// banded_lookup), which compares each 128-query tile of an offset against one
// window row of the table on the TPU's vector unit, after a pre-pass that
// picks the rows, and falls back to a bucketed lookup where a tile's queries
// do not fit their window.
//
// Design: one thread per query.  A lower-bound binary search over the
// cloud's row of the table (<= 16 steps at 40,960 rows; a table of at most
// 160 KB per cloud, read through L1/L2), then one equality test.  No window
// and no pre-pass, so the result is exact on all data and needs no band
// calibration.  Bound: the bytes of the query and position arrays and one
// read of the table; the search's dependent loads are latency that enough
// threads in flight hide.
#include <cuda_runtime.h>
#include <stdint.h>

namespace egonn {

constexpr int32_t kMaxKey = 2147483647;

__global__ void lookup_kernel(const int32_t* __restrict__ keys,
                              const int32_t* __restrict__ queries,
                              int32_t* __restrict__ pos, int batch, int c_in, int n_q) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)batch * n_q) return;
  const int32_t q = queries[i];
  int32_t out = c_in;
  if (q != kMaxKey) {
    const int32_t* kb = keys + (i / n_q) * (size_t)c_in;
    int lo = 0, hi = c_in;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(kb + mid) < q) lo = mid + 1; else hi = mid;
    }
    if (lo < c_in && __ldg(kb + lo) == q) out = lo;
  }
  pos[i] = out;
}

}  // namespace egonn

extern "C" int egonn_lookup(const int32_t* keys, const int32_t* queries, int32_t* pos,
                            int batch, int c_in, int n_q, void* stream) {
  const size_t n = (size_t)batch * n_q;
  if (n == 0) return 0;
  egonn::lookup_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(keys, queries, pos, batch,
                                                              c_in, n_q);
  return (int)cudaGetLastError();
}
