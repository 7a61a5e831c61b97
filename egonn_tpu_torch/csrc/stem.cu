// The stem convolution over constant-ones features:
//
//   out[b, c, :] = sum_k [kmap[b, k, c] < n_in] * W[k, :]
//
// W is the stem's (K, 1, F_out) kernel read as (K, F_out); kmap is the level-0
// self map (B, K, C), whose entries only say whether a neighbour exists (the
// features are all ones), with the sentinel n_in for none.  Its weight
// gradient is one torch.mm on the 0/1 matrix rebuilt from the saved map
// (sparse/conv.py): the features are constant, so there is no dX.
//
// Replaces no Pallas kernel: the JAX package computes the stem with jnp
// (egonn_tpu/sparse/conv.py::sparse_conv_ones, the 0/1 map times W, left to
// XLA).  The same form on the card compares and casts the whole map into a
// 0/1 f32 matrix (1.31 GB at 64 clouds x 125 offsets x 40,960 voxels), writes
// it, and multiplies it by W in f32 on cuBLAS: a dense GEMM over a matrix that
// is ~95% zeros, 2.1 ms on an H100 at that shape, 4.3x the least time of the
// same sum.
//
// Bound: bytes.  The map is read once (4 bytes an entry) and the output
// written once.  A valid entry costs F_out f32 additions (one row of W): 8
// additions a byte at F_out = 32, which the FP32 pipes would match only at a
// full map; the level-0 maps are 5-12% full.  The design keeps the map's
// reads in flight and moves nothing else through device memory:
// stem_ones_kernel, grid (ceil(C / threads), ceil(F_out / 32), B).  One
// thread per voxel column c of a cloud, 32 f32 accumulators (one 32-wide
// slice of F_out).  The slice of W (K x 32 f32, 16 KB at K = 125, zero padded
// past F_out) sits in shared memory.  Each thread walks k = 0 .. K-1, reading
// kmap[b, k, c] with streaming loads, coalesced across c, 8 offsets ahead of
// its sums; where the neighbour exists it adds W's row k (read as a broadcast
// from shared memory) into its accumulators.  A warp then stages its 32 rows
// in shared memory (float4 q of row r at q ^ (r & 7): conflict-free both
// ways) and writes them as whole rows, 512 contiguous bytes a store.  Order
// of the additions: offsets 0 .. K-1 into one f32 accumulator per output, as
// a GEMM without split-K sums them (0 * w adds nothing).
//
// Shapes: F_out a multiple of 4, 1 <= K <= 343 (W fits shared memory); the
// entry point returns cudaErrorInvalidValue otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace egonn {

constexpr int kStemSlice = 32;       // output features of a block: 8 float4 a row
constexpr int kStemMaxK = 343;
constexpr int kStemAhead = 8;        // map entries a thread loads ahead of its sums
constexpr int kStemMaxThreads = 512;

// float4 q (< 8) of the slice's row k of W, zero past the slice's fs features
__device__ __forceinline__ float4 w_chunk(const float* w, int k, int q, int f0, int fs,
                                          int f_out) {
  if (4 * q >= fs) return make_float4(0.f, 0.f, 0.f, 0.f);
  return *reinterpret_cast<const float4*>(w + (size_t)k * f_out + f0 + 4 * q);
}

__global__ void __launch_bounds__(kStemMaxThreads)
stem_ones_kernel(const int32_t* __restrict__ kmap, const float* __restrict__ w,
                 float* __restrict__ out, int k_vol, int c_out, int f_out, int n_in) {
  extern __shared__ float4 stem_smem[];
  float4* w_s = stem_smem;                    // k_vol rows x 8 float4
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* stage = stem_smem + k_vol * 8 + warp * 256;  // this warp's 32 rows x 8 float4
  const int b = blockIdx.z, f0 = blockIdx.y * kStemSlice;
  const int fs = min(kStemSlice, f_out - f0);
  for (int i = tid; i < k_vol * 8; i += blockDim.x) w_s[i] = w_chunk(w, i >> 3, i & 7, f0, fs, f_out);
  __syncthreads();

  const int col = blockIdx.x * blockDim.x + tid;
  const bool live = col < c_out;
  const int32_t* m = kmap + (size_t)b * k_vol * c_out + col;
  float acc[kStemSlice];
#pragma unroll
  for (int j = 0; j < kStemSlice; ++j) acc[j] = 0.f;
  // entries past K or past the cloud's columns read as the sentinel
  int32_t cur[kStemAhead];
#pragma unroll
  for (int u = 0; u < kStemAhead; ++u)
    cur[u] = (live && u < k_vol) ? __ldcs(m + (size_t)u * c_out) : n_in;
  for (int k0 = 0; k0 < k_vol; k0 += kStemAhead) {
    int32_t nxt[kStemAhead];
#pragma unroll
    for (int u = 0; u < kStemAhead; ++u) {
      const int k = k0 + kStemAhead + u;
      nxt[u] = (live && k < k_vol) ? __ldcs(m + (size_t)k * c_out) : n_in;
    }
#pragma unroll
    for (int u = 0; u < kStemAhead; ++u) {
      if (cur[u] < n_in) {
        const float4* wr = w_s + (k0 + u) * 8;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = wr[q];
          acc[4 * q] += v.x;
          acc[4 * q + 1] += v.y;
          acc[4 * q + 2] += v.z;
          acc[4 * q + 3] += v.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStemAhead; ++u) cur[u] = nxt[u];
  }

#pragma unroll
  for (int q = 0; q < 8; ++q)
    stage[lane * 8 + (q ^ (lane & 7))] =
        make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  __syncwarp();
  const int row0 = blockIdx.x * blockDim.x + warp * 32;
  float* ob = out + ((size_t)b * c_out + row0) * f_out + f0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = j * 32 + lane, r = i >> 3, q = i & 7;
    if (4 * q < fs && row0 + r < c_out)
      *reinterpret_cast<float4*>(ob + (size_t)r * f_out + 4 * q) = stage[r * 8 + (q ^ (r & 7))];
  }
}

inline bool stem_shapes_ok(int k_vol, int f_out) {
  return k_vol >= 1 && k_vol <= kStemMaxK && f_out >= 4 && f_out % 4 == 0;
}

int stem_ones(const int32_t* kmap, const float* w, float* out, int batch, int k_vol, int c_out,
              int f_out, int n_in, int threads, cudaStream_t st) {
  if (!stem_shapes_ok(k_vol, f_out) || threads < 32 || threads > kStemMaxThreads ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || c_out == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float4) * ((size_t)k_vol * 8 + (size_t)(threads / 32) * 256);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stem_ones_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((c_out + threads - 1) / threads, (f_out + kStemSlice - 1) / kStemSlice, batch);
  stem_ones_kernel<<<grid, threads, smem, st>>>(kmap, w, out, k_vol, c_out, f_out, n_in);
  return (int)cudaGetLastError();
}

}  // namespace egonn

// kmap (batch, k_vol, c_out) int32, w (k_vol, f_out) f32, out (batch, c_out,
// f_out) f32, all contiguous and 16-byte aligned; threads a multiple of 32 up
// to 512 (columns of a block).  Returns cudaGetLastError() (or the first
// error).
extern "C" int egonn_stem_ones(const int32_t* kmap, const float* w, float* out, int batch,
                               int k_vol, int c_out, int f_out, int n_in, int threads,
                               void* stream) {
  return egonn::stem_ones(kmap, w, out, batch, k_vol, c_out, f_out, n_in, threads,
                          static_cast<cudaStream_t>(stream));
}
