// Sparse convolution with a fused eval-mode epilogue:
//   out[b, c] = mask[b, c] ? relu?(scale * sum_k feats[b, kmap[b, k, c]] @ w[k] + bias) : 0
//
// Replaces egonn_tpu/sparse/banded.py::_pallas_banded_conv (wrapper
// banded_conv_pallas), which builds a one-hot over a band window of the
// key-sorted feature table and multiplies it on the MXU in bf16.  Here the
// rows are gathered directly (no window, so no band overflow) and multiplied
// on the tensor cores; see gather_mm.cuh for the design and what bounds it.
// `cols` is the output-column slice of a block; `n_groups` > 1 splits the
// offsets across blocks, summed in `partial`.
//
// egonn_gather_conv: f32 features, weights and output, split TF32 (f32
// accuracy).  egonn_gather_conv_bf16: bf16 features and output and
// w_t = W^T (k_vol, f_out, f_in) rounded to bf16, the TPU kernel's numerics
// (bf16 products, f32 sums and epilogue, one rounding at the store).
#include "gather_mm.cuh"

extern "C" int egonn_gather_conv(const float* feats, const int32_t* kmap, const float* w,
                                 const float* scale, const float* bias, const uint8_t* mask,
                                 float* out, float* partial, int n_groups, int batch, int c_in,
                                 int f_in, int k_vol, int c_out, int f_out, int cols, int relu,
                                 void* stream) {
  return egonn::launch_gather_mm(feats, kmap, w, scale, bias, mask, out, partial, n_groups,
                                 batch, c_in, f_in, k_vol, c_out, f_out, cols, relu, 0,
                                 egonn::kCutNone, static_cast<cudaStream_t>(stream));
}

// `body`: 1 the Hopper body (gather_mm_sm90.cuh), 0 the SM80 one
// (gather_mm_bf16_kernel).
extern "C" int egonn_gather_conv_bf16(const egonn::bf16* feats, const int32_t* kmap,
                                      const egonn::bf16* w_t, const float* scale,
                                      const float* bias, const uint8_t* mask, egonn::bf16* out,
                                      float* partial, int n_groups, int batch, int c_in,
                                      int f_in, int k_vol, int c_out, int f_out, int cols,
                                      int relu, int body, void* stream) {
  return egonn::launch_gather_mm(feats, kmap, w_t, scale, bias, mask, out, partial, n_groups,
                                 batch, c_in, f_in, k_vol, c_out, f_out, cols, relu, body,
                                 egonn::kCutNone, static_cast<cudaStream_t>(stream));
}

#ifdef EGONN_PROBE_CUTS
// The cut-out `cut` (bf16.cuh) of bf16 body `body`, for probe_kernels.py;
// `lists`: room for the SM80 body's compacted lists (kCutCompactOnly writes
// them, kCutNoMapScan reads them), else null.
extern "C" int egonn_gather_conv_bf16_cut(const egonn::bf16* feats, const int32_t* kmap,
                                          const egonn::bf16* w_t, const float* scale,
                                          const float* bias, const uint8_t* mask,
                                          egonn::bf16* out, float* partial, int n_groups,
                                          int batch, int c_in, int f_in, int k_vol, int c_out,
                                          int f_out, int cols, int relu, int body, int cut,
                                          int* lists, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cut < egonn::kCutNone || cut > egonn::kCutNoWeights ||
      (body == 1 && cut == egonn::kCutNoMapScan) || (body == 0 && cut == egonn::kCutNoWeights) ||
      (body == 0 && cut >= egonn::kCutNoMapScan && !lists))
    return (int)cudaErrorInvalidValue;
  if (lists) {
    const cudaError_t err =
        cudaMemcpyToSymbolAsync(egonn::conv_cut_lists, &lists, sizeof(lists), 0,
                                cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  return egonn::launch_gather_mm(feats, kmap, w_t, scale, bias, mask, out, partial, n_groups,
                                 batch, c_in, f_in, k_vol, c_out, f_out, cols, relu, body, cut,
                                 st);
}
#endif
