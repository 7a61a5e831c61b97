// Gather-and-multiply body shared by the sparse conv (gather_conv.cu) and the
// transposed down conv (tdown.cu):
//
//   out[b, r, :] = epi( sum_k feats[b, kmap[b, k, r], :] @ w[k] )
//   epi(v)       = mask[b, r] ? relu?(v * scale + bias) : 0
//
// A kmap entry outside [0, c_in) (the sentinel c_in) gathers a zero row.
//
// Replaces the TPU's banded one-hot MXU gather (egonn_tpu/sparse/banded.py
// _pallas_banded_conv / _pallas_banded_tdown).  On Hopper a direct row gather
// needs no band window, so this kernel is exact on all data.
//
// Design: one block of 256 threads per (cloud, tile of 64 output rows).  For
// each kernel offset k the block loads the tile's 64 indices; if all are the
// sentinel it skips offset k entirely (capacity slack beyond a cloud's
// occupancy is a contiguous tail of all-sentinel tiles, since voxels are
// key-sorted with MAXKEY padding last).  Otherwise it gathers the 64 source
// rows into shared memory (zeros for the sentinel), stages w[k] (F_in x F_out,
// at most 128 x 128 f32 = 64 KB) in shared memory, and every thread
// accumulates a column of the tile in f32 registers with FMAs, reading four
// input features per 16-byte shared load.  Offsets and features are summed
// in a fixed order, so results are deterministic.  The epilogue is applied
// once, at the single store.
//
// Bound: at EgoNN widths (32-128 channels) the f32 FMAs dominate the bytes
// moved, so the kernel is bound by operations; the inner loop issues one
// 16-byte broadcast shared load per four FMAs per row, close to the SM's
// shared-memory rate.  Tensor cores (bf16 or TF32 wgmma) are the next step.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace egonn {

constexpr int kTileRows = 64;
constexpr int kThreads = 256;

inline size_t gather_mm_smem_bytes(int f_in, int f_out) {
  return sizeof(float) * (size_t)(f_in * f_out + kTileRows * f_in);
}

template <int FOUT>
__global__ void __launch_bounds__(kThreads)
gather_mm_kernel(const float* __restrict__ feats, const int32_t* __restrict__ kmap,
                 const float* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, int c_in, int f_in, int k_vol, int c_out,
                 int relu) {
  static_assert(kThreads % FOUT == 0, "FOUT must divide the block");
  constexpr int kRowsPerPass = kThreads / FOUT;
  constexpr int kRowsPerThread = kTileRows / kRowsPerPass;

  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);   // f_in x FOUT
  float4* a_s = smem4 + (f_in * FOUT) / 4;        // kTileRows x f_in/4
  __shared__ int idx_s[kTileRows];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.x;
  const int col = tid % FOUT;
  const int rsub = tid / FOUT;
  const int f4 = f_in / 4;

  const float* feats_b = feats + (size_t)b * c_in * f_in;
  const int32_t* kmap_b = kmap + (size_t)b * k_vol * c_out;

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int k = 0; k < k_vol; ++k) {
    int valid = 0;
    if (tid < kTileRows) {
      const int r = row0 + tid;
      const int src = r < c_out ? kmap_b[(size_t)k * c_out + r] : c_in;
      valid = (unsigned)src < (unsigned)c_in;
      idx_s[tid] = valid ? src : -1;
    }
    // also the barrier between the previous offset's reads and these writes
    if (!__syncthreads_or(valid)) continue;

    for (int e = tid; e < kTileRows * f4; e += kThreads) {
      const int r = e / f4;
      const int q = e - r * f4;
      const int src = idx_s[r];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src >= 0) v = reinterpret_cast<const float4*>(feats_b + (size_t)src * f_in)[q];
      a_s[e] = v;
    }
    const float4* w_k = reinterpret_cast<const float4*>(w + (size_t)k * f_in * FOUT);
    for (int e = tid; e < f_in * FOUT / 4; e += kThreads) smem4[e] = w_k[e];
    __syncthreads();

    for (int q = 0; q < f4; ++q) {
      const float w0 = w_s[(4 * q + 0) * FOUT + col];
      const float w1 = w_s[(4 * q + 1) * FOUT + col];
      const float w2 = w_s[(4 * q + 2) * FOUT + col];
      const float w3 = w_s[(4 * q + 3) * FOUT + col];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 a = a_s[(rsub + i * kRowsPerPass) * f4 + q];
        float s = acc[i];
        s = fmaf(a.x, w0, s);
        s = fmaf(a.y, w1, s);
        s = fmaf(a.z, w2, s);
        s = fmaf(a.w, w3, s);
        acc[i] = s;
      }
    }
  }

  const float sc = scale ? scale[col] : 1.f;
  const float bi = bias ? bias[col] : 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = row0 + rsub + i * kRowsPerPass;
    if (r >= c_out) continue;
    float v = acc[i];
    if (scale) v = v * sc + bi;
    if (relu) v = fmaxf(v, 0.f);
    if (mask && !mask[(size_t)b * c_out + r]) v = 0.f;
    out[((size_t)b * c_out + r) * FOUT + col] = v;
  }
}

// Launches gather_mm_kernel for f_out in {32, 64, 128}; f_in % 4 == 0.
// Returns cudaGetLastError() (or the attribute call's error).
inline int launch_gather_mm(const float* feats, const int32_t* kmap, const float* w,
                            const float* scale, const float* bias, const uint8_t* mask,
                            float* out, int batch, int c_in, int f_in, int k_vol,
                            int c_out, int f_out, int relu, cudaStream_t stream) {
  const size_t smem = gather_mm_smem_bytes(f_in, f_out);
  const dim3 grid((c_out + kTileRows - 1) / kTileRows, batch);
  cudaError_t err = cudaSuccess;
#define EGONN_LAUNCH(FO)                                                           \
  case FO:                                                                        \
    err = cudaFuncSetAttribute(gather_mm_kernel<FO>,                              \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,       \
                               (int)smem);                                        \
    if (err != cudaSuccess) return (int)err;                                      \
    gather_mm_kernel<FO><<<grid, kThreads, smem, stream>>>(                        \
        feats, kmap, w, scale, bias, mask, out, c_in, f_in, k_vol, c_out, relu);  \
    break;
  switch (f_out) {
    EGONN_LAUNCH(32)
    EGONN_LAUNCH(64)
    EGONN_LAUNCH(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EGONN_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace egonn
