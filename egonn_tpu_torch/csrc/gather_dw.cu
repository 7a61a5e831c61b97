// Conv-weight gradient of the sparse gather conv (gather_conv.cu):
//
//   dW[k] = sum_b sum_o feats[b, kmap[b, k, o], :]^T g[b, o, :]     (F_in x F_out)
//
// A kmap entry outside [0, c_in) (the sentinel c_in) gathers a zero row.
//
// Replaces egonn_tpu/sparse/banded.py:688 _pallas_banded_dw (wrapper
// banded_conv_dw, :764).  The TPU kernel gathers each tile's rows with a bf16
// one-hot over a band window and accumulates dW in one VMEM block that its
// sequential (B, T) grid revisits.  On Hopper blocks run in parallel and
// nothing carries between them, so the reduction over tiles takes two passes,
// and rows are gathered directly (no window: exact on all data):
//
// 1. gather_dw_partial_kernel, grid (n_chunks, K), 256 threads.  Block (c, k)
//    walks the 64-row tiles t = c, c + n_chunks, ... of all B x ceil(C_out/64)
//    (cloud, tile) pairs; the stride makes every chunk sample the clouds'
//    occupied prefixes alike.  It skips a tile whose 64 indices at offset k
//    are all sentinel (the capacity slack past a cloud's voxels is a
//    contiguous tail of such tiles), else gathers the 64 source rows (zeros
//    for the sentinel) and the tile's 64 rows of g into shared memory, and
//    each of the 16 x 16 threads adds its (F_in/16) x (F_out/16) share of the
//    tile's 64 outer products in f32 registers (FMA).  The block then writes
//    its partial dW[k] to partial[c, k].
// 2. gather_dw_reduce_kernel sums partial[0 .. n_chunks-1] in index order.
//
// No float atomics, and a fixed summation order: the result is deterministic.
// The wrapper picks n_chunks = ceil(264 / K), at most the tile count: two
// blocks per SM of the H100's 132 at K = 8 (33 chunks) and K = 27 (10).
//
// Bound: bytes of feats, kmap, g and dW, each moved once, against
// 2 * nnz * F_in * F_out f32 operations (nnz = valid kmap entries).  At
// EgoNN widths (32-128 channels) the operations bound it.  Per row the inner
// loop issues F_in/16 + F_out/16 shared loads for (F_in/16)(F_out/16) FMAs.
// Tensor cores are the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace egonn {

constexpr int kDwRows = 64;
constexpr int kDwThreads = 256;
constexpr int kDwGrid = 16;  // 16 x 16 threads tile the F_in x F_out output

inline size_t gather_dw_smem_bytes(int f_in, int f_out) {
  return sizeof(float) * (size_t)kDwRows * (f_in + f_out);
}

template <int FIN, int FOUT>
__global__ void __launch_bounds__(kDwThreads)
gather_dw_partial_kernel(const float* __restrict__ feats, const int32_t* __restrict__ kmap,
                         const float* __restrict__ g, float* __restrict__ partial,
                         int batch, int c_in, int k_vol, int c_out) {
  static_assert(FIN % kDwGrid == 0 && FOUT % kDwGrid == 0, "widths must be multiples of 16");
  constexpr int TM = FIN / kDwGrid;
  constexpr int TN = FOUT / kDwGrid;
  constexpr int FIN4 = FIN / 4;
  constexpr int FOUT4 = FOUT / 4;

  extern __shared__ float4 dw_smem4[];
  float4* a_s = dw_smem4;                    // kDwRows x FIN/4: gathered feats
  float4* g_s = dw_smem4 + kDwRows * FIN4;   // kDwRows x FOUT/4: the tile's g
  __shared__ int idx_s[kDwRows];

  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kDwGrid;  // output columns tx + 16 j
  const int ty = tid / kDwGrid;  // output rows ty + 16 i
  const int tiles_per_cloud = (c_out + kDwRows - 1) / kDwRows;
  const int n_tiles = batch * tiles_per_cloud;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t = chunk; t < n_tiles; t += n_chunks) {
    const int b = t / tiles_per_cloud;
    const int row0 = (t - b * tiles_per_cloud) * kDwRows;
    int valid = 0;
    if (tid < kDwRows) {
      const int r = row0 + tid;
      const int src = r < c_out ? kmap[((size_t)b * k_vol + k) * c_out + r] : c_in;
      valid = (unsigned)src < (unsigned)c_in;
      idx_s[tid] = valid ? src : -1;
    }
    // also the barrier between the previous tile's reads and these writes
    if (!__syncthreads_or(valid)) continue;

    const float* feats_b = feats + (size_t)b * c_in * FIN;
    for (int e = tid; e < kDwRows * FIN4; e += kDwThreads) {
      const int r = e / FIN4;
      const int src = idx_s[r];
      a_s[e] = src >= 0 ? reinterpret_cast<const float4*>(feats_b + (size_t)src * FIN)[e - r * FIN4]
                        : zero4;
    }
    const float4* g_tile =
        reinterpret_cast<const float4*>(g + ((size_t)b * c_out + row0) * FOUT);
    const int n_g4 = min(kDwRows, c_out - row0) * FOUT4;
    for (int e = tid; e < kDwRows * FOUT4; e += kDwThreads) g_s[e] = e < n_g4 ? g_tile[e] : zero4;
    __syncthreads();

    const float* a_f = reinterpret_cast<const float*>(a_s);
    const float* g_f = reinterpret_cast<const float*>(g_s);
#pragma unroll 4
    for (int r = 0; r < kDwRows; ++r) {
      float av[TM], gv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_f[r * FIN + ty + i * kDwGrid];
#pragma unroll
      for (int j = 0; j < TN; ++j) gv[j] = g_f[r * FOUT + tx + j * kDwGrid];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
  }

  float* out = partial + ((size_t)chunk * k_vol + k) * FIN * FOUT;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) out[(ty + i * kDwGrid) * FOUT + tx + j * kDwGrid] = acc[i][j];
}

__global__ void gather_dw_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int n_chunks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[(size_t)c * n + i];
  out[i] = s;
}

template <int FIN, int FOUT>
cudaError_t launch_gather_dw_partial(const float* feats, const int32_t* kmap, const float* g,
                                     float* partial, int batch, int c_in, int k_vol,
                                     int c_out, int n_chunks, cudaStream_t stream) {
  const size_t smem = gather_dw_smem_bytes(FIN, FOUT);
  cudaError_t err = cudaFuncSetAttribute(gather_dw_partial_kernel<FIN, FOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  gather_dw_partial_kernel<FIN, FOUT><<<dim3(n_chunks, k_vol), kDwThreads, smem, stream>>>(
      feats, kmap, g, partial, batch, c_in, k_vol, c_out);
  return cudaGetLastError();
}

template <int FIN>
cudaError_t dispatch_f_out(int f_out, const float* feats, const int32_t* kmap, const float* g,
                           float* partial, int batch, int c_in, int k_vol, int c_out,
                           int n_chunks, cudaStream_t stream) {
  switch (f_out) {
    case 32:
      return launch_gather_dw_partial<FIN, 32>(feats, kmap, g, partial, batch, c_in, k_vol,
                                               c_out, n_chunks, stream);
    case 64:
      return launch_gather_dw_partial<FIN, 64>(feats, kmap, g, partial, batch, c_in, k_vol,
                                               c_out, n_chunks, stream);
    case 128:
      return launch_gather_dw_partial<FIN, 128>(feats, kmap, g, partial, batch, c_in, k_vol,
                                                c_out, n_chunks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace egonn

// f_in, f_out in {32, 64, 128}; partial holds n_chunks * k_vol * f_in * f_out
// floats, out k_vol * f_in * f_out.  Returns cudaGetLastError() (or the first
// error of the attribute call or a launch).
extern "C" int egonn_gather_dw(const float* feats, const int32_t* kmap, const float* g,
                               float* partial, float* out, int batch, int c_in, int f_in,
                               int k_vol, int c_out, int f_out, int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (f_in) {
    case 32:
      err = egonn::dispatch_f_out<32>(f_out, feats, kmap, g, partial, batch, c_in, k_vol,
                                      c_out, n_chunks, st);
      break;
    case 64:
      err = egonn::dispatch_f_out<64>(f_out, feats, kmap, g, partial, batch, c_in, k_vol,
                                      c_out, n_chunks, st);
      break;
    case 128:
      err = egonn::dispatch_f_out<128>(f_out, feats, kmap, g, partial, batch, c_in, k_vol,
                                       c_out, n_chunks, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int n = k_vol * f_in * f_out;
  egonn::gather_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(partial, out, n_chunks, n);
  return (int)cudaGetLastError();
}
