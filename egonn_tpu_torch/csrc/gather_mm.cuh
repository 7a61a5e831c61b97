// Gather-and-multiply body of the sparse conv (gather_conv.cu):
//
//   out[b, r, :] = epi( sum_k feats[b, kmap[b, k, r], :] @ w[k] )
//   epi(v)       = mask[b, r] ? relu?(v * scale + bias) : 0
//
// A kmap entry outside [0, c_in) (the sentinel c_in) gathers a zero row.
//
// Replaces the TPU's banded one-hot MXU gather (egonn_tpu/sparse/banded.py
// _pallas_banded_conv).  On Hopper a direct row gather needs no band
// window, so this kernel is exact on all data.
//
// Design: one block of 256 threads (8 warps) per (32- or 64-column slice
// NS of F_out, tile of 128 output rows, cloud); the slices of one tile are
// neighbours in the grid, so they find the tile's gathered rows in L2.
// - Work follows the valid map entries, not the dense tile: the maps are
//   sparse (on EgoNN's LiDAR pyramid 14% of (row, offset) entries are valid
//   at L1-L2, under 1% at L7).  For a group of up to 32 offsets the block
//   loads the tile's kmap entries and compacts each offset's valid
//   (row, source) pairs, in row order, into shared memory.  Offsets without
//   one are skipped.
// - It then walks the (offset, F_in chunk of <= 32 columns) stages in a
//   fixed order through a ring of shared-memory buffers (three for NS = 32,
//   two for NS = 64, where two blocks still fit an SM): each stage's n valid
//   rows are gathered into rows 0 .. n-1 of its buffer with cp.async (16
//   bytes a thread; columns past F_in zero-filled by src-size 0), beside
//   w[k][chunk, NS], while earlier stages multiply.  Rows are padded (A by 4
//   floats, w by 8) so the fragment loads hit 32 distinct banks.  F_in not a
//   multiple of 8 is zero-padded to the MMA depth.
// - Warp w owns the 16 output columns w mod (NS / 16) and every
//   (8 / (NS / 16))-th of the stage's ceil(n / 16) 16-row tiles; it
//   multiplies them on the tensor cores with mma.sync m16n8k8 in split TF32
//   (tf32x3.cuh: f32 accuracy), each operand split once as it leaves shared
//   memory and rows past n read as zero.  The three split products of its
//   two 8-column tiles go to six fresh accumulators, which do not wait for
//   one another (a dependent mma.sync waits out the one before it); they
//   are combined and added, in f32, to a 128 x NS accumulator tile in
//   shared memory at the rows' places (the tensor cores' own accumulation
//   truncates, so it is kept to one stage's four MMA steps).  Within a stage
//   each (row, column) has one owner; stages follow in offset order.
// - The epilogue is applied once, at the single store from the accumulator
//   tile.  No atomics and a fixed summation order: equal inputs give
//   bit-equal outputs.
//
// Why the column split: at the deep levels a cloud has one occupied row
// tile, so a block per tile left most SMs idle while a few walked all 27
// offsets; slicing 128 output columns four ways puts 4x the blocks on those
// levels, each staging only its slice of w[k] (the 64 KB w[k] of a 128 x 128
// conv does not fit beside the rows, let alone at 512 wide).
//
// bf16 features (gather_mm_bf16_kernel, the TPU kernel's numerics;
// bf16.cuh): the same blocks, maps (compact_group), ring and epilogue; a
// stage is 64 F_in columns (the same 128 bytes of a row as 32 f32 columns),
// w arrives rounded and transposed, W^T (K, F_out, F_in) in bf16, so that
// the stage holds its NS rows, and each 16-row tile is one mma.sync
// m16n8k16 per 16 deep per 8 columns (mma_stage_bf16) instead of three
// m16n8k8 per 8 deep.  The accumulator, the offset groups' partial sums and
// the epilogue stay in f32; the store rounds once to bf16.  The f32 body
// stays a kernel of its own: one body templated on the element type gave
// its f32 instance fewer registers (80-94 against 115, with spills at 80)
// and 5% more time on an H100 (PERF.md).  It is one of two bf16 bodies: the
// Hopper one (gather_mm_sm90.cuh: wgmma, an mbarrier ring, TMA) takes the
// calls `kernels.conv_body` sends it, this one the rest.
//
// Bound: f32, three TF32 MMAs per product at 495 TFLOP/s dense, i.e. 165
// TFLOP/s of f32 work; bf16, one MMA per product at 989 TFLOP/s; against the
// bytes of feats, kmap, w and out (bf16 rows halve the gathered bytes).  At
// EgoNN widths the operations bound the f32 path on paper; in practice the
// stages are short (a few valid rows each), so each stage's barrier and its
// round trip to L2 for scattered rows and w set the pace (PERF.md).
#pragma once

#include <type_traits>

#include "bf16.cuh"
#include "gather_mm_sm90.cuh"
#include "tf32x3.cuh"

namespace egonn {

constexpr int kTileRows = 128;    // output rows per block
constexpr int kThreads = 256;     // 8 warps
constexpr int kChunk = 32;        // F_in columns per stage (f32)
constexpr int kLdA = kChunk + 4;  // shared row stride of the gathered rows (floats)
constexpr int kChunkH = 64;       // F_in columns per stage (bf16: the same 128 bytes of a row)
constexpr int kLdH = kChunkH + 8;  // shared row stride of the gathered rows and W^T rows (bf16)
constexpr int kGroup = 32;        // offsets whose maps are held at once

// ring depth: three stages where two blocks still fit an SM, else two
template <int NS>
__host__ __device__ constexpr int mm_stages() {
  return NS == 32 ? 3 : 2;
}
template <int NS>
__host__ __device__ constexpr int stage_floats() {
  return kTileRows * kLdA + kChunk * (NS + 8);
}
template <int NS>
__host__ __device__ constexpr int mm_float_bytes() {  // stages + the accumulator tile
  return 4 * (mm_stages<NS>() * stage_floats<NS>() + kTileRows * (NS + 8));
}
// bf16: a stage holds the gathered rows and W^T's NS rows of the slice
template <int NS>
__host__ __device__ constexpr int stage_halves() {
  return (kTileRows + NS) * kLdH;
}
template <int NS>
__host__ __device__ constexpr int mm_bf16_bytes() {  // stages + the f32 accumulator tile
  return 2 * mm_stages<NS>() * stage_halves<NS>() + 4 * kTileRows * (NS + 8);
}

template <typename T>
inline size_t gather_mm_smem_bytes(int ns) {
  constexpr bool f32 = std::is_same_v<T, float>;
  const int bytes = ns == 64 ? (f32 ? mm_float_bytes<64>() : mm_bf16_bytes<64>())
                             : (f32 ? mm_float_bytes<32>() : mm_bf16_bytes<32>());
  return (size_t)bytes + sizeof(int) * (kGroup * (kTileRows + 2) + 1);
}

// Steps 1-3 of a group of offsets [k0, k0 + kg) of a tile: its kmap entries
// (pair_s), each offset's valid (row, source) pairs compacted in row order
// in place as (row << 24) | source with their count (cnt_s), and the
// offsets with any pair in ascending order (list_s, their count at
// list_s[kGroup]).
__device__ __forceinline__ void compact_group(const int32_t* kmap_b, int k0, int kg, int row0,
                                              int c_in, int c_out, int* pair_s, int* cnt_s,
                                              int* list_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the last group's stages are done with pair_s and list_s
  // 1. the tile's kmap entries at the group's offsets
#pragma unroll 4
  for (int e = tid; e < kg * kTileRows; e += kThreads) {
    const int k = k0 + e / kTileRows, r = e % kTileRows;
    pair_s[e] = row0 + r < c_out ? kmap_b[(size_t)k * c_out + row0 + r] : c_in;
  }
  __syncthreads();
  // 2. per offset, its valid (row, source) pairs compacted in row order, in
  // place: (row << 24) | source
  for (int kl = warp; kl < kg; kl += kThreads / 32) {
    int* p = pair_s + kl * kTileRows;
    int n = 0;
    for (int base = 0; base < kTileRows; base += 32) {
      const int src = p[base + lane];
      const bool v = (unsigned)src < (unsigned)c_in;
      const unsigned m = __ballot_sync(0xffffffffu, v);
      if (v) p[n + __popc(m & ((1u << lane) - 1))] = ((base + lane) << 24) | src;
      n += __popc(m);
    }
    if (lane == 0) cnt_s[kl] = n;
  }
  __syncthreads();
  // 3. the group's offsets with any valid pair, in ascending order
  if (warp == 0) {
    const bool f = lane < kg && cnt_s[lane] > 0;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (f) list_s[__popc(m & ((1u << lane) - 1))] = lane;
    if (lane == 0) list_s[kGroup] = __popc(m);
  }
  __syncthreads();
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
gather_mm_kernel(const float* __restrict__ feats, const int32_t* __restrict__ kmap,
                 const float* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ partial, int n_groups, int batch,
                 int c_in, int f_in, int k_vol, int c_out, int f_out, int relu) {
  constexpr int kStages = mm_stages<NS>();
  constexpr int kLdB = NS + 8;   // shared row stride of the w slice (floats)
  constexpr int kLdC = NS + 8;   // shared row stride of the accumulator tile
  constexpr int kStage = stage_floats<NS>();
  constexpr int NP = NS / 16;    // pairs of 8-column MMA tiles; a warp owns one
  constexpr int MG = kThreads / 32 / NP;  // warps sharing a column pair

  extern __shared__ float4 smem4[];
  float* stage_s = reinterpret_cast<float*>(smem4);                // kStages x kStage
  float* acc_s = stage_s + kStages * kStage;                       // 128 x kLdC
  int* pair_s = reinterpret_cast<int*>(acc_s + kTileRows * kLdC);  // kGroup x 128
  int* cnt_s = pair_s + kGroup * kTileRows;                        // kGroup
  int* list_s = cnt_s + kGroup;                                    // active offsets, count

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int np = warp % NP, mg = warp / NP;
  // the column slices of one tile are neighbours in the grid, so they find
  // the tile's gathered rows in L2
  const int col0 = blockIdx.x * NS;
  const int row0 = blockIdx.y * kTileRows;
  const int b = blockIdx.z / n_groups, grp = blockIdx.z % n_groups;
  // this block's offsets: group grp of n_groups contiguous ranges
  const int k_per = (k_vol + n_groups - 1) / n_groups;
  const int k_lo = grp * k_per, k_hi = min(k_vol, k_lo + k_per);
  const float* feats_b = feats + (size_t)b * c_in * f_in;
  const int32_t* kmap_b = kmap + (size_t)b * k_vol * c_out;

  for (int e = tid; e < kTileRows * kLdC; e += kThreads) acc_s[e] = 0.f;
  const int n_chunks = (f_in + kChunk - 1) / kChunk;
  auto padded = [&](int c) { return (min(kChunk, f_in - c * kChunk) + 7) & ~7; };

  // the offsets in groups of kGroup, in ascending order
  for (int k0 = k_lo; k0 < k_hi; k0 += kGroup) {
    const int kg = min(kGroup, k_hi - k0);
    compact_group(kmap_b, k0, kg, row0, c_in, c_out, pair_s, cnt_s, list_s);

    const int n_stages = list_s[kGroup] * n_chunks;  // (active offset, F_in chunk) pairs

    // stage s -> buffer `buf`: offset k0 + kl, kl = list_s[s / n_chunks], and
    // chunk c = s % n_chunks: the offset's n valid rows' chunk c gathered into
    // rows 0 .. n-1, and w[k]'s rows of chunk c in this block's column slice
    auto load_stage = [&](int s, int buf) {
      const int kl = list_s[s / n_chunks], c = s % n_chunks;
      float* a_s = stage_s + buf * kStage;
      float* b_s = a_s + kTileRows * kLdA;
      const int c0 = c * kChunk;
      const int kc = min(kChunk, f_in - c0);  // valid columns (a multiple of 4)
      const int q4 = padded(c) / 4;           // 16-byte pieces per padded row
      // a row's 16-byte pieces on neighbouring lanes: a warp's copy touches
      // 32 / q4 rows, not 32
      const int* pairs = pair_s + kl * kTileRows;
      for (int e = tid; e < cnt_s[kl] * q4; e += kThreads) {
        const int j = e / q4, q = e - j * q4;
        const bool ok = 4 * q < kc;
        const float* src = feats_b + (size_t)(pairs[j] & 0xffffff) * f_in + c0 + 4 * q;
        cp_async16(a_s + j * kLdA + 4 * q, ok ? src : feats, ok ? 16 : 0);
      }
      const float* w_k = w + ((size_t)(k0 + kl) * f_in + c0) * f_out + col0;
      for (int e = tid; e < 4 * q4 * (NS / 4); e += kThreads) {
        const int rr = e / (NS / 4), q = e % (NS / 4);
        const bool ok = rr < kc;
        cp_async16(b_s + rr * kLdB + 4 * q, ok ? w_k + (size_t)rr * f_out + 4 * q : w,
                   ok ? 16 : 0);
      }
    };

    // warp (np, mg) multiplies the stage's 16-row tiles mg, mg + MG, ... by
    // its 16 columns np and adds each into the accumulator tile at the rows'
    // places; within a stage every (row, column) has one owner.  Six
    // independent accumulators (2 column tiles x 3 split products) keep the
    // tensor cores busy across the MMAs' latency.
    auto compute_stage = [&](int s, int buf) {
      const int kl = list_s[s / n_chunks], c = s % n_chunks;
      const int n = cnt_s[kl];
      const int* pairs = pair_s + kl * kTileRows;
      const float* a_s = stage_s + buf * kStage;
      const float* b_s = a_s + kTileRows * kLdA + np * 16;
      const int kcp = padded(c);
      for (int mt = mg; mt * 16 < n; mt += MG) {
        const int j0 = mt * 16 + g, j1 = j0 + 8;  // this lane's compacted rows
        const bool v0 = j0 < n, v1 = j1 < n;      // rows past n hold stale data
        float part[2][3][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 12; ++e) part[nt][e / 4][e % 4] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < kcp; kk += 8) {
          uint32_t a_hi[4], a_lo[4], b_hi[2][2], b_lo[2][2];
          const float* p = a_s + j0 * kLdA + kk + t;
          split_tf32(v0 ? p[0] : 0.f, a_hi[0], a_lo[0]);
          split_tf32(v1 ? p[8 * kLdA] : 0.f, a_hi[1], a_lo[1]);
          split_tf32(v0 ? p[4] : 0.f, a_hi[2], a_lo[2]);
          split_tf32(v1 ? p[8 * kLdA + 4] : 0.f, a_hi[3], a_lo[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* q = b_s + (kk + t) * kLdB + nt * 8 + g;
            split_tf32(q[0], b_hi[nt][0], b_lo[nt][0]);
            split_tf32(q[4 * kLdB], b_hi[nt][1], b_lo[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_3xtf32_sets(part[nt], a_hi, a_lo, b_hi[nt], b_lo[nt]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = part[nt][0][e] + (part[nt][1][e] + part[nt][2][e]);
          const int col = np * 16 + nt * 8 + 2 * t;
          if (v0) {
            float2* dst = reinterpret_cast<float2*>(acc_s + (pairs[j0] >> 24) * kLdC + col);
            const float2 o = *dst;
            *dst = make_float2(o.x + v[0], o.y + v[1]);
          }
          if (v1) {
            float2* dst = reinterpret_cast<float2*>(acc_s + (pairs[j1] >> 24) * kLdC + col);
            const float2 o = *dst;
            *dst = make_float2(o.x + v[2], o.y + v[3]);
          }
        }
      }
    };

    // 4. the stages through a ring of kStages buffers, kStages - 1 in flight:
    // stage s + kStages - 1 is loaded into the buffer that stage s - 1 left
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_stages) load_stage(s, s);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<kStages - 2>();  // stage s has landed
      __syncthreads();               // ... for every thread; stage s - 1 is done
      if (s + kStages - 1 < n_stages) load_stage(s + kStages - 1, (s + kStages - 1) % kStages);
      cp_async_commit();
      compute_stage(s, s % kStages);
    }
  }
  __syncthreads();

  // 5. the epilogue at the single store, 16 bytes a thread; with offset
  // groups, this group's raw sum to its partial (gather_mm_sum_kernel adds
  // the groups in order and applies the epilogue)
  for (int e = tid; e < kTileRows * (NS / 4); e += kThreads) {
    const int r = e / (NS / 4), q = e % (NS / 4);
    const int row = row0 + r;
    if (row >= c_out) continue;
    const int col = col0 + 4 * q;
    float4 v = *reinterpret_cast<const float4*>(acc_s + r * kLdC + 4 * q);
    if (n_groups > 1) {
      *reinterpret_cast<float4*>(
          partial + (((size_t)grp * batch + b) * c_out + row) * f_out + col) = v;
      continue;
    }
    if (scale) {
      v.x = v.x * scale[col] + bias[col];
      v.y = v.y * scale[col + 1] + bias[col + 1];
      v.z = v.z * scale[col + 2] + bias[col + 2];
      v.w = v.w * scale[col + 3] + bias[col + 3];
    }
    if (relu) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f);
      v.w = fmaxf(v.w, 0.f);
    }
    if (mask && !mask[(size_t)b * c_out + row]) v = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(out + ((size_t)b * c_out + row) * f_out + col) = v;
  }
}

#ifdef EGONN_PROBE_CUTS
// the compacted lists of every (tile, cloud x group, group of offsets), which
// the kCutCompactOnly cut-out of gather_mm_bf16_kernel writes and its
// kCutNoMapScan cut-out reads (probe_kernels.py)
__device__ int* conv_cut_lists;
#endif

// The bf16 body: the f32 body's blocks, offset groups, maps, ring and
// epilogue, with bf16 rows (64 F_in columns a stage), W^T's rows of the
// slice beside them, and mma_stage_bf16 for the products; the accumulator
// stays f32 and the store rounds once to bf16.
template <int NS, int CUT = kCutNone>
__global__ void __launch_bounds__(kThreads)
gather_mm_bf16_kernel(const bf16* __restrict__ feats, const int32_t* __restrict__ kmap,
                      const bf16* __restrict__ w_t, const float* __restrict__ scale,
                      const float* __restrict__ bias, const uint8_t* __restrict__ mask,
                      bf16* __restrict__ out, float* __restrict__ partial, int n_groups,
                      int batch, int c_in, int f_in, int k_vol, int c_out, int f_out, int relu) {
  constexpr int kStages = mm_stages<NS>();
  constexpr int kLdC = NS + 8;   // shared row stride of the accumulator tile
  constexpr int kStage = stage_halves<NS>();
  constexpr int NP = NS / 16;    // pairs of 8-column MMA tiles; a warp owns one
  constexpr int MG = kThreads / 32 / NP;  // warps sharing a column pair

  extern __shared__ float4 smem4[];
  bf16* stage_s = reinterpret_cast<bf16*>(smem4);                       // kStages x kStage
  float* acc_s = reinterpret_cast<float*>(stage_s + kStages * kStage);  // 128 x kLdC
  int* pair_s = reinterpret_cast<int*>(acc_s + kTileRows * kLdC);       // kGroup x 128
  int* cnt_s = pair_s + kGroup * kTileRows;                             // kGroup
  int* list_s = cnt_s + kGroup;                                         // active offsets, count

  const int tid = threadIdx.x, warp = tid >> 5;
  const int np = warp % NP, mg = warp / NP;
  const int col0 = blockIdx.x * NS;
  const int row0 = blockIdx.y * kTileRows;
  const int b = blockIdx.z / n_groups, grp = blockIdx.z % n_groups;
  const int k_per = (k_vol + n_groups - 1) / n_groups;
  const int k_lo = grp * k_per, k_hi = min(k_vol, k_lo + k_per);
  const bf16* feats_b = feats + (size_t)b * c_in * f_in;
  const int32_t* kmap_b = kmap + (size_t)b * k_vol * c_out;

  for (int e = tid; e < kTileRows * kLdC; e += kThreads) acc_s[e] = 0.f;
  const int n_chunks = (f_in + kChunkH - 1) / kChunkH;
  // a chunk's columns padded to the MMA depth
  auto padded = [&](int c) { return (min(kChunkH, f_in - c * kChunkH) + 15) & ~15; };

  for (int k0 = k_lo; k0 < k_hi; k0 += kGroup) {
#ifdef EGONN_PROBE_CUTS
    int* saved = conv_cut_lists + ((((size_t)blockIdx.z * gridDim.y + blockIdx.y) * kGroup +
                                    (k0 - k_lo) / kGroup) * (kGroup * (kTileRows + 2) + 1));
    if constexpr (CUT == kCutNoMapScan) {
      __syncthreads();
      for (int e = tid; e < kGroup * (kTileRows + 2) + 1; e += kThreads) pair_s[e] = saved[e];
      __syncthreads();
    } else
#endif
      compact_group(kmap_b, k0, min(kGroup, k_hi - k0), row0, c_in, c_out, pair_s, cnt_s,
                    list_s);
#ifdef EGONN_PROBE_CUTS
    if constexpr (CUT == kCutCompactOnly) {
      if (blockIdx.x == 0)
        for (int e = tid; e < kGroup * (kTileRows + 2) + 1; e += kThreads) saved[e] = pair_s[e];
      continue;
    }
#endif
    const int n_stages = list_s[kGroup] * n_chunks;  // (active offset, F_in chunk) pairs

    // stage s -> buffer `buf`: offset k0 + kl, kl = list_s[s / n_chunks], and
    // chunk c = s % n_chunks: the offset's valid rows' chunk c gathered into
    // rows 0 .. n-1 (8 bf16 a copy), and W^T[k]'s NS rows of the slice,
    // chunk c's columns
    auto load_stage = [&](int s, int buf) {
      const int kl = list_s[s / n_chunks], c = s % n_chunks;
      bf16* a_s = stage_s + buf * kStage;
      bf16* b_s = a_s + kTileRows * kLdH;
      const int c0 = c * kChunkH;
      const int kc = min(kChunkH, f_in - c0);  // valid columns (a multiple of 8)
      const int q8 = padded(c) / 8;            // 16-byte pieces per padded row
      const int* pairs = pair_s + kl * kTileRows;
      for (int e = tid; e < (CUT == kCutNoGather ? 0 : cnt_s[kl] * q8); e += kThreads) {
        const int j = e / q8, q = e - j * q8;
        const bool ok = 8 * q < kc;
        const bf16* src = feats_b + (size_t)(pairs[j] & 0xffffff) * f_in + c0 + 8 * q;
        cp_async16(a_s + j * kLdH + 8 * q, ok ? src : feats, ok ? 16 : 0);
      }
      const bf16* w_k = w_t + ((size_t)(k0 + kl) * f_out + col0) * f_in + c0;
      for (int e = tid; e < NS * q8; e += kThreads) {
        const int n = e / q8, q = e - n * q8;
        const bool ok = 8 * q < kc;
        cp_async16(b_s + n * kLdH + 8 * q, ok ? w_k + (size_t)n * f_in + 8 * q : w_t,
                   ok ? 16 : 0);
      }
    };
    auto compute_stage = [&](int s, int buf) {
      if constexpr (CUT == kCutNoMma) return;
      const int kl = list_s[s / n_chunks], c = s % n_chunks;
      const bf16* a_s = stage_s + buf * kStage;
      mma_stage_bf16(a_s, kLdH, a_s + (kTileRows + np * 16) * kLdH, kLdH,
                     pair_s + kl * kTileRows, cnt_s[kl], padded(c), mg, MG, acc_s, kLdC,
                     np * 16);
    };

    // 4. the stages through a ring of kStages buffers, kStages - 1 in flight
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_stages) load_stage(s, s);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<kStages - 2>();  // stage s has landed
      __syncthreads();               // ... for every thread; stage s - 1 is done
      if (s + kStages - 1 < n_stages) load_stage(s + kStages - 1, (s + kStages - 1) % kStages);
      cp_async_commit();
      compute_stage(s, s % kStages);
    }
  }
  __syncthreads();

  // 5. the epilogue at the single store, rounding once to bf16; with offset
  // groups, this group's raw f32 sum to its partial
  for (int e = tid; e < kTileRows * (NS / 4); e += kThreads) {
    const int r = e / (NS / 4), q = e % (NS / 4);
    const int row = row0 + r;
    if (row >= c_out) continue;
    const int col = col0 + 4 * q;
    const float4 v = *reinterpret_cast<const float4*>(acc_s + r * kLdC + 4 * q);
    if (n_groups > 1) {
      *reinterpret_cast<float4*>(
          partial + (((size_t)grp * batch + b) * c_out + row) * f_out + col) = v;
      continue;
    }
    store4(out + ((size_t)b * c_out + row) * f_out + col,
           epi4(v, scale, bias, col, relu, !mask || mask[(size_t)b * c_out + row]));
  }
}

// out = epi(sum over g of partial[g]), the groups in index order; one
// thread per 4 outputs
template <typename T>
__global__ void gather_mm_sum_kernel(const float4* __restrict__ partial,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     const uint8_t* __restrict__ mask, T* __restrict__ out,
                                     int n_groups, int rows, int f_out, int relu) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n4 = (size_t)rows * f_out / 4;
  if (i >= n4) return;
  float4 v = partial[i];
  for (int grp = 1; grp < n_groups; ++grp) {
    const float4 u = partial[grp * n4 + i];
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  const int col = (int)(i % (f_out / 4)) * 4;
  store4(out + 4 * i, epi4(v, scale, bias, col, relu, !mask || mask[i / (f_out / 4)]));
}

#ifdef EGONN_PROBE_CUTS
// the cut-out `cut` (bf16.cuh) of the NS-column SM80 bf16 body
template <int NS>
auto gather_mm_bf16_body(int cut) {
  switch (cut) {
    case kCutNoMma: return gather_mm_bf16_kernel<NS, kCutNoMma>;
    case kCutNoGather: return gather_mm_bf16_kernel<NS, kCutNoGather>;
    case kCutNoMapScan: return gather_mm_bf16_kernel<NS, kCutNoMapScan>;
    case kCutCompactOnly: return gather_mm_bf16_kernel<NS, kCutCompactOnly>;
    default: return gather_mm_bf16_kernel<NS, kCutNone>;
  }
}
#else
template <int NS>
auto gather_mm_bf16_body(int) {
  return gather_mm_bf16_kernel<NS, kCutNone>;
}
#endif

// Launches gather_mm_kernel with column slices of `cols` (32 or 64, dividing
// f_out); f_in a multiple of 4 (f32) or 8 (bf16, w as W^T (k_vol, f_out,
// f_in)).  bf16 takes `body`: 1 the Hopper body (gather_mm_sm90.cuh), 0 the
// SM80 one, and `cut` kCutNone (or, built with EGONN_PROBE_CUTS, a cut-out
// of the body).  With n_groups > 1 the offsets are split into that many
// contiguous ranges, each block summing one range of one tile into
// `partial` (n_groups x batch x c_out x f_out floats), and
// gather_mm_sum_kernel adds them.  Returns cudaGetLastError() (or the
// attribute call's or the tensor map's error).
template <typename T>
int launch_gather_mm(const T* feats, const int32_t* kmap, const T* w, const float* scale,
                     const float* bias, const uint8_t* mask, T* out, float* partial,
                     int n_groups, int batch, int c_in, int f_in, int k_vol, int c_out, int f_out,
                     int cols, int relu, int body, int cut, cudaStream_t stream) {
  constexpr bool f32 = std::is_same_v<T, float>;
  constexpr int vec = f32 ? 4 : 8;  // elements of a 16-byte row piece
  if ((cols != 32 && cols != 64) || f_out % cols || f_in % vec || f_in <= 0 ||
      k_vol <= 0 || c_in >= (1 << 24) || n_groups < 1 || n_groups > k_vol ||
      (n_groups > 1 && !partial) || (body != 0 && body != 1) || (f32 && (body || cut)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(f_out / cols, (c_out + kTileRows - 1) / kTileRows, batch * n_groups);
  cudaError_t err;
  if constexpr (f32) {
    const size_t smem = gather_mm_smem_bytes<T>(cols);
    auto kern = cols == 64 ? gather_mm_kernel<64> : gather_mm_kernel<32>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, stream>>>(feats, kmap, w, scale, bias, mask, out, partial,
                                           n_groups, batch, c_in, f_in, k_vol, c_out, f_out,
                                           relu);
  } else if (body == 1) {
    const int e = launch_gather_mm_sm90(feats, kmap, w, scale, bias, mask, out, partial,
                                        n_groups, batch, c_in, f_in, k_vol, c_out, f_out, cols,
                                        relu, cut, stream);
    if (e != 0) return e;
  } else {
    const size_t smem = gather_mm_smem_bytes<T>(cols);
    auto kern = cols == 64 ? gather_mm_bf16_body<64>(cut) : gather_mm_bf16_body<32>(cut);
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, stream>>>(feats, kmap, w, scale, bias, mask, out, partial,
                                           n_groups, batch, c_in, f_in, k_vol, c_out, f_out,
                                           relu);
  }
  if (n_groups > 1) {
    const size_t n4 = (size_t)batch * c_out * f_out / 4;
    gather_mm_sum_kernel<T><<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(partial), scale, bias, mask, out, n_groups,
        batch * c_out, f_out, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace egonn
