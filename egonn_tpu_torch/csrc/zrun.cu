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
// Design: one thread per query.  A lower-bound binary search over the
// cloud's table (<= 15 steps at 16384 rows; the table is 64 KB per cloud and
// stays in L1/L2) gives rank; then the present keys of the run are the next
// <= kz consecutive table rows, since keys are unique and sorted.  No window,
// so the result is exact on all data.  Bound: the bytes of the query and
// output arrays (the table reads hit cache); the search's dependent loads
// are latency that enough threads in flight hide.
#include <cuda_runtime.h>
#include <stdint.h>

namespace egonn {

constexpr int32_t kMaxKey = 2147483647;

__global__ void zrun_kernel(const int32_t* __restrict__ keys,
                            const int32_t* __restrict__ q_lo, int32_t* __restrict__ bits,
                            int32_t* __restrict__ rank, int batch, int c_in, int n_q,
                            int kz) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)batch * n_q) return;
  const int32_t q = q_lo[i];
  if (q == kMaxKey) {
    bits[i] = 0;
    if (rank) rank[i] = 0;
    return;
  }
  const int32_t* kb = keys + (i / n_q) * (size_t)c_in;
  int lo = 0, hi = c_in;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(kb + mid) < q) lo = mid + 1; else hi = mid;
  }
  int m = 0;
  for (int j = 0; j < kz && lo + j < c_in; ++j) {
    const long long d = (long long)__ldg(kb + lo + j) - q;
    if (d >= kz) break;
    m |= 1 << d;
  }
  bits[i] = m;
  if (rank) rank[i] = lo;
}

int launch(const int32_t* keys, const int32_t* q_lo, int32_t* bits, int32_t* rank,
           int batch, int c_in, int n_q, int kz, void* stream) {
  const size_t n = (size_t)batch * n_q;
  zrun_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, q_lo, bits, rank, batch, c_in, n_q, kz);
  return (int)cudaGetLastError();
}

}  // namespace egonn

extern "C" int egonn_zrun_presence(const int32_t* keys, const int32_t* q_lo,
                                   int32_t* bits, int batch, int c_in, int n_q, int kz,
                                   void* stream) {
  return egonn::launch(keys, q_lo, bits, nullptr, batch, c_in, n_q, kz, stream);
}

extern "C" int egonn_zrun_rank(const int32_t* keys, const int32_t* q_lo, int32_t* bits,
                               int32_t* rank, int batch, int c_in, int n_q, int kz,
                               void* stream) {
  return egonn::launch(keys, q_lo, bits, rank, batch, c_in, n_q, kz, stream);
}
