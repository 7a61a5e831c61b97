// Transposed k=2 s=2 down conv driven by the fine level's up map:
//   out[b, p] = epi( sum over fine i with up_parent[b, i] == p of
//                    feats[b, i] @ w[up_koffset[b, i]] )
//
// Replaces egonn_tpu/sparse/banded.py::_pallas_banded_tdown (wrapper
// banded_tdown_pallas), which compares a window of up-parents against the
// coarse tile's rows to build a one-hot on the TPU.
//
// Design: two small kernels invert the up map into a per-coarse child index
// child[b, slot, p] (sentinel c_fine).  Each (parent, slot) pair has at most
// one child, so the inversion is a unique-index scatter: deterministic, no
// atomics.  The child index is exactly the down conv's gather map
// (kmap_down), so the third launch is the gather-and-multiply body of the
// sparse conv (gather_mm.cuh) with K = 8, summing the slots in a fixed order.
// Bound: the f32 FMAs, as for the sparse conv; the inversion moves
// 12 bytes per fine voxel and 4 per (slot, coarse voxel).
#include "gather_mm.cuh"

namespace egonn {

__global__ void fill_kernel(int32_t* __restrict__ child, size_t n, int value) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) child[i] = value;
}

__global__ void invert_up_kernel(const int32_t* __restrict__ up_parent,
                                 const int32_t* __restrict__ up_koffset,
                                 int32_t* __restrict__ child, int batch, int c_fine,
                                 int c_coarse) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)batch * c_fine) return;
  const int b = (int)(i / c_fine);
  const int f = (int)(i - (size_t)b * c_fine);
  const int p = up_parent[i];
  const int s = up_koffset[i];
  if ((unsigned)p < (unsigned)c_coarse && (unsigned)s < 8u)
    child[((size_t)b * 8 + s) * c_coarse + p] = f;
}

}  // namespace egonn

extern "C" int egonn_tdown(const float* feats, const int32_t* up_parent,
                           const int32_t* up_koffset, const float* w, const float* scale,
                           const float* bias, const uint8_t* mask, int32_t* child,
                           float* out, int batch, int c_fine, int f_in, int c_coarse,
                           int f_out, int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_child = (size_t)batch * 8 * c_coarse;
  const size_t n_fine = (size_t)batch * c_fine;
  egonn::fill_kernel<<<(unsigned)((n_child + 255) / 256), 256, 0, st>>>(child, n_child, c_fine);
  egonn::invert_up_kernel<<<(unsigned)((n_fine + 255) / 256), 256, 0, st>>>(
      up_parent, up_koffset, child, batch, c_fine, c_coarse);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return egonn::launch_gather_mm(feats, child, w, scale, bias, mask, out, batch, c_fine,
                                 f_in, 8, c_coarse, f_out, relu, st);
}
