// Sparse convolution with a fused eval-mode epilogue:
//   out[b, c] = mask[b, c] ? relu?(scale * sum_k feats[b, kmap[b, k, c]] @ w[k] + bias) : 0
//
// Replaces egonn_tpu/sparse/banded.py::_pallas_banded_conv (wrapper
// banded_conv_pallas), which builds a one-hot over a band window of the
// key-sorted feature table and multiplies it on the MXU in bf16.  Here the
// rows are gathered directly (no window, so no band overflow) and multiplied
// in f32; see gather_mm.cuh for the design and what bounds it.
#include "gather_mm.cuh"

extern "C" int egonn_gather_conv(const float* feats, const int32_t* kmap, const float* w,
                                 const float* scale, const float* bias,
                                 const uint8_t* mask, float* out, int batch, int c_in,
                                 int f_in, int k_vol, int c_out, int f_out, int relu,
                                 void* stream) {
  return egonn::launch_gather_mm(feats, kmap, w, scale, bias, mask, out, batch, c_in,
                                 f_in, k_vol, c_out, f_out, relu,
                                 static_cast<cudaStream_t>(stream));
}
