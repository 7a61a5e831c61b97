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
// 1. gather_dw_partial_kernel, grid (K, n_chunks, slices), 128 threads.
//    Block (k, c, s) owns an MB x NB slice s of dW[k] (MB, NB = 32 or 64)
//    and walks the 64-row tiles t = c, c + n_chunks, ... of all
//    B x ceil(C_out/64) (cloud, tile) pairs; the stride makes every chunk
//    sample the clouds' occupied prefixes alike, and the offsets of one
//    chunk are neighbours in the grid, so they share the tiles' rows of g in
//    L2.  Only the rows with a valid index at offset k count (the maps are
//    sparse: 14-24% of the entries at EgoNN's L1-L2): a tile's valid rows
//    are compacted, in row order, into rows 0 .. n-1 of a buffer, each with
//    its gathered features (MB columns) and its row of g (NB columns), by
//    cp.async through a ring of three shared-memory buffers, two tiles in
//    flight while one multiplies; each thread loads one row's index a tile
//    ahead, a ballot gives the row its place, and the warp copies its 16
//    rows with each row's pieces on neighbouring lanes.  A
//    tile without a valid row costs one barrier.  The 2 x 2 warps then add
//    the tile's A^T (MB x n) . G (n x NB), the depth n rounded up to 8, to
//    their 32 x 32 (or smaller) register pieces on the tensor cores,
//    mma.sync m16n8k8 in split TF32 (tf32x3.cuh: f32 accuracy), into fresh
//    accumulators added to the running sum in f32 after each tile; A's
//    fragments are read transposed from the row-major tile, and rows are
//    padded by 8 floats so they hit 32 distinct banks.  The block then
//    writes its slice of partial[c, k].
// 2. gather_dw_reduce_kernel sums partial[0 .. n_chunks-1] in index order.
//
// No float atomics, and a fixed summation order: the result is deterministic.
// Slicing F_in and F_out keeps the accumulators at <= 32 registers a thread
// at any width up to 512; each slice re-gathers the same rows from L2.  The
// wrapper picks n_chunks so the partial pass has ~8 blocks per SM of the
// H100's 132 (sparse/kernels.py).
//
// Bound: bytes of feats, kmap, g and dW, each moved once, against
// 2 * nnz * F_in * F_out f32 operations (nnz = valid kmap entries), the
// operations at three TF32 MMAs each: at EgoNN widths the operations on
// paper; in practice each tile's barrier and the round trip for its
// scattered rows (PERF.md).
//
// bf16 operands (egonn_gather_dw_bf16): the TPU kernel's numerics
// (banded.py:728-735, :788: features and g in bf16, their exact products
// summed in f32, dW f32).  gather_dw_bf16_partial_kernel keeps the frame
// above (grid, 64-row tiles, compaction by ballot, the cp.async ring, the
// ordered second pass) on bf16 rows, and multiplies with mma.sync
// m16n8k16 (bf16.cuh).  The contraction runs over the gathered rows, so
// both fragments pair two neighbouring rows of one column: ldmatrix .trans
// reads them from the row-major tiles (rows padded by 16 bytes, so the 8
// rows of one 8x8 matrix hit 32 distinct banks), and the depth is rounded
// up to 16 by masking the rows past n in the registers (stale rows may hold
// any bits).  Each tile's products go straight into the one running f32
// accumulator, as the TPU kernel's do.  It is its own kernel, not the f32
// body templated on the element type: that cost the f32 gather body
// registers and time (PERF.md, "ptxas").  Bound: 2 bytes a feature and g
// element, against the same operations at the bf16 tensor-core rate.
#include <type_traits>

#include "bf16.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace egonn {

constexpr int kDwRows = 64;
constexpr int kDwThreads = 128;
constexpr int kDwStages = 3;  // ring of tiles in shared memory: 2 in flight

inline size_t gather_dw_smem_bytes(int mb, int nb) {
  return sizeof(float) * kDwStages * (size_t)kDwRows * (mb + 8 + nb + 8) +
         sizeof(int) * (kDwStages + 1) * (kDwThreads / 32);
}

template <int MB, int NB>
__global__ void __launch_bounds__(kDwThreads)
gather_dw_partial_kernel(const float* __restrict__ feats, const int32_t* __restrict__ kmap,
                         const float* __restrict__ g, float* __restrict__ partial, int batch,
                         int c_in, int f_in, int k_vol, int c_out, int f_out) {
  constexpr int kLdA = MB + 8, kLdG = NB + 8;  // shared row strides (floats)
  constexpr int kStage = kDwRows * (kLdA + kLdG);
  constexpr int MT = MB / 32, NT = NB / 16;    // MMA tiles per warp (MB/2 x NB/2)
  constexpr int kWarps = kDwThreads / 32;

  extern __shared__ float4 dw_smem4[];
  float* stage_s = reinterpret_cast<float*>(dw_smem4);  // kDwStages x kStage
  // valid rows per warp's 16 rows, for steps i mod (kDwStages + 1)
  int* cnt_s = reinterpret_cast<int*>(stage_s + kDwStages * kStage);

  const int k = blockIdx.x, chunk = blockIdx.y, n_chunks = gridDim.y;
  const int n_slices = f_out / NB;
  const int f0 = (blockIdx.z / n_slices) * MB, n0 = (blockIdx.z % n_slices) * NB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int r = tid >> 1, half = tid & 1;  // the row whose index this thread loads
  const int tiles_per_cloud = (c_out + kDwRows - 1) / kDwRows;
  const int n_tiles = batch * tiles_per_cloud;
  const int n_steps = chunk < n_tiles ? (n_tiles - 1 - chunk) / n_chunks + 1 : 0;

  // this thread's row of step i's tile at offset k: its kmap entry (c_in
  // past the end)
  auto raw_index = [&](int i) -> int {
    const int tile = chunk + i * n_chunks;
    const int b = tile / tiles_per_cloud;
    const int row = (tile - b * tiles_per_cloud) * kDwRows + r;
    return i < n_steps && row < c_out ? kmap[((size_t)b * k_vol + k) * c_out + row] : c_in;
  };

  // Step i's valid rows are compacted, in row order, into rows 0 .. n-1 of
  // its buffer: the row's place is the valid rows before it, counted per
  // warp (16 rows each) with a ballot and summed over the warps in cnt_s.
  // Called by all threads between the copies' barrier and their issue.
  auto count_tile = [&](int raw, int i) {
    const bool v = (unsigned)raw < (unsigned)c_in;
    const unsigned m = __ballot_sync(0xffffffffu, v && !half);  // even lanes: one per row
    if (lane == 0) cnt_s[(i % (kDwStages + 1)) * kWarps + warp] = __popc(m);
    return __popc(m & ((1u << (lane & ~1)) - 1));  // valid rows before mine in my warp
  };
  // Copies step i's valid rows to their places (nothing for a step without
  // one).  Called by all threads (the shuffles need the whole warp): the
  // lanes of a warp copy its 16 rows with a row's 16-byte pieces on
  // neighbouring lanes, each row's index and place shuffled from the lane
  // that loaded it.
  auto load_tile = [&](int raw, int i, int pos) {
    const int* cnt = cnt_s + (i % (kDwStages + 1)) * kWarps;
    if (cnt[0] + cnt[1] + cnt[2] + cnt[3] == 0) return;  // block-uniform
    for (int w = 0; w < warp; ++w) pos += cnt[w];
    float* a_s = stage_s + (i % kDwStages) * kStage;
    float* g_s = a_s + kDwRows * kLdA;
    const int tile = chunk + i * n_chunks;
    const int b = tile / tiles_per_cloud;
    const int row0 = (tile - b * tiles_per_cloud) * kDwRows + warp * 16;  // this warp's rows
    constexpr int PA = MB / 4, PG = NB / 4;  // 16-byte pieces per row
#pragma unroll
    for (int jr0 = 0; jr0 < 16; jr0 += 32 / PA) {
      const int jr = jr0 + lane / PA, q = lane % PA;
      const int src = __shfl_sync(0xffffffffu, raw, 2 * jr);
      const int at = __shfl_sync(0xffffffffu, pos, 2 * jr);
      if ((unsigned)src < (unsigned)c_in)
        cp_async16(a_s + at * kLdA + 4 * q, feats + ((size_t)b * c_in + src) * f_in + f0 + 4 * q,
                   16);
    }
#pragma unroll
    for (int jr0 = 0; jr0 < 16; jr0 += 32 / PG) {
      const int jr = jr0 + lane / PG, q = lane % PG;
      const int src = __shfl_sync(0xffffffffu, raw, 2 * jr);
      const int at = __shfl_sync(0xffffffffu, pos, 2 * jr);
      if ((unsigned)src < (unsigned)c_in)
        cp_async16(g_s + at * kLdG + 4 * q,
                   g + ((size_t)b * c_out + row0 + jr) * f_out + n0 + 4 * q, 16);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // step i's n compacted rows: A^T (MB x n) . G (n x NB), depth n rounded up
  // to the MMA's 8 (the rows past n hold stale data and are read as zero)
  auto compute_tile = [&](int i) {
    const int* cnt = cnt_s + (i % (kDwStages + 1)) * kWarps;
    const int n = cnt[0] + cnt[1] + cnt[2] + cnt[3];
    if (n == 0) return;
    const float* a_s = stage_s + (i % kDwStages) * kStage + wm * (MB / 2);
    const float* g_s = stage_s + (i % kDwStages) * kStage + kDwRows * kLdA + wn * (NB / 2);
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
    for (int kk = 0; kk < n; kk += 8) {
      const bool v0 = kk + t < n, v1 = kk + t + 4 < n;
      uint32_t a_hi[MT][4], a_lo[MT][4], b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {  // A[m][j] = a_s[j][m]: the tile transposed
        const float* p = a_s + (kk + t) * kLdA + mt * 16 + gq;
        split_tf32(v0 ? p[0] : 0.f, a_hi[mt][0], a_lo[mt][0]);
        split_tf32(v0 ? p[8] : 0.f, a_hi[mt][1], a_lo[mt][1]);
        split_tf32(v1 ? p[4 * kLdA] : 0.f, a_hi[mt][2], a_lo[mt][2]);
        split_tf32(v1 ? p[4 * kLdA + 8] : 0.f, a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* p = g_s + (kk + t) * kLdG + nt * 8 + gq;
        split_tf32(v0 ? p[0] : 0.f, b_hi[nt][0], b_lo[nt][0]);
        split_tf32(v1 ? p[4 * kLdG] : 0.f, b_hi[nt][1], b_lo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_3xtf32(part[mt][nt], a_hi[mt], a_lo[mt], b_hi[nt], b_lo[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  };

  // The steps through a ring of kDwStages buffers: step i + kDwStages - 1 is
  // loaded into the buffer that step i - 1 left.  Its row counts go to slot
  // (i + kDwStages - 1) mod (kDwStages + 1) before the barrier, never the slot
  // that step i - 1, still computing on slower warps, reads.
  int raw = raw_index(0);
  for (int j = 0; j < kDwStages - 1; ++j) {
    const int next = raw_index(j + 1);
    const int pos = count_tile(raw, j);
    __syncthreads();
    load_tile(raw, j, pos);
    cp_async_commit();
    raw = next;
  }
  for (int i = 0; i < n_steps; ++i) {
    const int next = raw_index(i + kDwStages);  // in flight during this step
    const int pos = count_tile(raw, i + kDwStages - 1);
    cp_async_wait<kDwStages - 2>();  // step i has landed
    __syncthreads();  // for every thread, with all counts; step i - 1 is done
    load_tile(raw, i + kDwStages - 1, pos);
    cp_async_commit();
    compute_tile(i);
    raw = next;
  }

  float* out = partial + ((size_t)chunk * k_vol + k) * f_in * f_out;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = f0 + wm * (MB / 2) + mt * 16 + gq + 8 * h;
        const int n = n0 + wn * (NB / 2) + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (size_t)m * f_out + n) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

inline size_t gather_dw_bf16_smem_bytes(int mb, int nb) {
  return sizeof(bf16) * kDwStages * (size_t)kDwRows * (mb + 8 + nb + 8) +
         sizeof(int) * (kDwStages + 1) * (kDwThreads / 32);
}

// Four 8x8 matrices of 16-bit elements from shared memory, each delivered
// transposed: lanes 8q .. 8q+7 give the addresses of matrix q's 8 rows (16
// bytes each), and lane (g = lane / 4, t = lane % 4) receives in r[q] the
// elements (2t, g) and (2t + 1, g) of the stored matrix, the first in the
// low half.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

template <int MB, int NB, int CUT = kCutNone>
__global__ void __launch_bounds__(kDwThreads)
gather_dw_bf16_partial_kernel(const bf16* __restrict__ feats, const int32_t* __restrict__ kmap,
                              const bf16* __restrict__ g, float* __restrict__ partial,
                              int batch, int c_in, int f_in, int k_vol, int c_out, int f_out) {
  constexpr int kLdA = MB + 8, kLdG = NB + 8;  // shared row strides (bf16)
  constexpr int kStage = kDwRows * (kLdA + kLdG);
  constexpr int MT = MB / 32, NT = NB / 16;    // MMA tiles per warp (MB/2 x NB/2)
  constexpr int kWarps = kDwThreads / 32;

  extern __shared__ float4 dwb_smem4[];
  bf16* stage_s = reinterpret_cast<bf16*>(dwb_smem4);  // kDwStages x kStage
  // valid rows per warp's 16 rows, for steps i mod (kDwStages + 1)
  int* cnt_s = reinterpret_cast<int*>(stage_s + kDwStages * kStage);

  const int k = blockIdx.x, chunk = blockIdx.y, n_chunks = gridDim.y;
  const int n_slices = f_out / NB;
  const int f0 = (blockIdx.z / n_slices) * MB, n0 = (blockIdx.z % n_slices) * NB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int r = tid >> 1, half = tid & 1;  // the row whose index this thread loads
  const int tiles_per_cloud = (c_out + kDwRows - 1) / kDwRows;
  const int n_tiles = batch * tiles_per_cloud;
  const int n_steps = chunk < n_tiles ? (n_tiles - 1 - chunk) / n_chunks + 1 : 0;

  // as in gather_dw_partial_kernel; the cut-out without the map's scan
  // reads no index and takes every seventh row (the maps' density at L1-L2)
  auto raw_index = [&](int i) -> int {
    const int tile = chunk + i * n_chunks;
    const int b = tile / tiles_per_cloud;
    const int row = (tile - b * tiles_per_cloud) * kDwRows + r;
    if constexpr (CUT == kCutNoMapScan)
      return i < n_steps && row < c_out && row % 7 == 0 ? row % c_in : c_in;
    return i < n_steps && row < c_out ? kmap[((size_t)b * k_vol + k) * c_out + row] : c_in;
  };
  auto count_tile = [&](int raw, int i) {
    const bool v = (unsigned)raw < (unsigned)c_in;
    const unsigned m = __ballot_sync(0xffffffffu, v && !half);  // even lanes: one per row
    if (lane == 0) cnt_s[(i % (kDwStages + 1)) * kWarps + warp] = __popc(m);
    return __popc(m & ((1u << (lane & ~1)) - 1));  // valid rows before mine in my warp
  };
  // step i's valid rows to their places, a row's 16-byte pieces (8 bf16) on
  // neighbouring lanes
  auto load_tile = [&](int raw, int i, int pos) {
    const int* cnt = cnt_s + (i % (kDwStages + 1)) * kWarps;
    if (cnt[0] + cnt[1] + cnt[2] + cnt[3] == 0) return;  // block-uniform
    if constexpr (CUT == kCutNoGather) return;
    for (int w = 0; w < warp; ++w) pos += cnt[w];
    bf16* a_s = stage_s + (i % kDwStages) * kStage;
    bf16* g_s = a_s + kDwRows * kLdA;
    const int tile = chunk + i * n_chunks;
    const int b = tile / tiles_per_cloud;
    const int row0 = (tile - b * tiles_per_cloud) * kDwRows + warp * 16;  // this warp's rows
    constexpr int PA = MB / 8, PG = NB / 8;  // 16-byte pieces per row
#pragma unroll
    for (int jr0 = 0; jr0 < 16; jr0 += 32 / PA) {
      const int jr = jr0 + lane / PA, q = lane % PA;
      const int src = __shfl_sync(0xffffffffu, raw, 2 * jr);
      const int at = __shfl_sync(0xffffffffu, pos, 2 * jr);
      if ((unsigned)src < (unsigned)c_in)
        cp_async16(a_s + at * kLdA + 8 * q, feats + ((size_t)b * c_in + src) * f_in + f0 + 8 * q,
                   16);
    }
#pragma unroll
    for (int jr0 = 0; jr0 < 16; jr0 += 32 / PG) {
      const int jr = jr0 + lane / PG, q = lane % PG;
      const int src = __shfl_sync(0xffffffffu, raw, 2 * jr);
      const int at = __shfl_sync(0xffffffffu, pos, 2 * jr);
      if ((unsigned)src < (unsigned)c_in)
        cp_async16(g_s + at * kLdG + 8 * q,
                   g + ((size_t)b * c_out + row0 + jr) * f_out + n0 + 8 * q, 16);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // This lane's ldmatrix rows.  A = the feature tile transposed, A[m][j] =
  // a_s[j][m]: matrix q covers m + 8 (q % 2), depths j + 8 (q / 2), so r[q]
  // is the A fragment's register q.  B = the g tile, B[j][n] = g_s[j][n]:
  // matrix q covers depths j + 8 (q % 2) and columns n + 8 (q / 2), so r[q]
  // is register q % 2 of the n8 tile q / 2.
  const int a_row = (lane >> 4) * 8 + (lane & 7), a_col = ((lane >> 3) & 1) * 8;
  const int g_row = ((lane >> 3) & 1) * 8 + (lane & 7), g_col = (lane >> 4) * 8;

  // step i's n compacted rows: A^T (MB x n) . G (n x NB), depth n rounded up
  // to the MMA's 16; the rows past n hold stale bits and are masked to zero
  // in both operands (0 x NaN would not be 0)
  auto compute_tile = [&](int i) {
    const int* cnt = cnt_s + (i % (kDwStages + 1)) * kWarps;
    const int n = cnt[0] + cnt[1] + cnt[2] + cnt[3];
    if (n == 0 || CUT == kCutNoMma) return;
    const bf16* a_s = stage_s + (i % kDwStages) * kStage + wm * (MB / 2);
    const bf16* g_s = stage_s + (i % kDwStages) * kStage + kDwRows * kLdA + wn * (NB / 2);
    for (int kk = 0; kk < n; kk += 16) {
      // this lane's depths: kk + 2t, kk + 2t + 1 (lo) and the same + 8 (hi)
      const int d = kk + 2 * t;
      const uint32_t lo = (d < n ? 0xffffu : 0u) | (d + 1 < n ? 0xffff0000u : 0u);
      const uint32_t hi = (d + 8 < n ? 0xffffu : 0u) | (d + 9 < n ? 0xffff0000u : 0u);
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldmatrix_x4_trans(a[mt], a_s + (kk + a_row) * kLdA + mt * 16 + a_col);
        a[mt][0] &= lo;
        a[mt][1] &= lo;
        a[mt][2] &= hi;
        a[mt][3] &= hi;
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t q[4];
        ldmatrix_x4_trans(q, g_s + (kk + g_row) * kLdG + np * 16 + g_col);
        b[2 * np][0] = q[0] & lo;
        b[2 * np][1] = q[1] & hi;
        b[2 * np + 1][0] = q[2] & lo;
        b[2 * np + 1][1] = q[3] & hi;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  };

  // the ring of gather_dw_partial_kernel
  int raw = raw_index(0);
  for (int j = 0; j < kDwStages - 1; ++j) {
    const int next = raw_index(j + 1);
    const int pos = count_tile(raw, j);
    __syncthreads();
    load_tile(raw, j, pos);
    cp_async_commit();
    raw = next;
  }
  for (int i = 0; i < n_steps; ++i) {
    const int next = raw_index(i + kDwStages);
    const int pos = count_tile(raw, i + kDwStages - 1);
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    load_tile(raw, i + kDwStages - 1, pos);
    cp_async_commit();
    compute_tile(i);
    raw = next;
  }

  float* out = partial + ((size_t)chunk * k_vol + k) * f_in * f_out;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = f0 + wm * (MB / 2) + mt * 16 + gq + 8 * h;
        const int n = n0 + wn * (NB / 2) + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (size_t)m * f_out + n) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// The Hopper body of the bf16 partial pass (gather_dw_sm90_kernel; body 1
// of egonn_gather_dw_bf16, which `kernels.dw_body` picks for every call but
// the 32-wide features' at K >= 27).  What held the SM80 body back: each
// 64-row map tile was its own multiply step, ~9 valid rows deep at 14%
// density and padded to 16, behind a block barrier whether or not the tile
// had a valid row.  Here:
// - Block (k, c, s) as above: two producer warps and one consumer
//   warpgroup.  The producer warps walk the block's tiles (strided as
//   above) alike, each lane holding two rows' indices of the next
//   kDwSmAhead tiles in registers; a ballot puts a tile's valid rows, in row
//   order, onto a running queue that fills stages of exactly 64 valid rows
//   across tiles (a tile's rows may span two stages); a tile without a
//   valid row costs no barrier.  Each producer warp copies every other
//   queued row (its MB feature columns and NB columns of g, a row's 16-byte
//   cp.async pieces on neighbouring lanes) into the stage's two 64 x 64
//   bf16 tiles (128-byte swizzle, one tile row per queued row), one commit
//   group a stage; once kDwSmLag later stages are closed and its group has
//   landed, each arrives once on the stage's full mbarrier.  A ring of
//   kDwSmStages stages, released by the consumers' empty mbarriers.  The
//   last stage of a chunk holds n < 64 rows; its rows up to the next 16 are
//   zero-filled (stale bits could be NaN, and 0 x NaN is not 0), and a header
//   word carries n (-1 ends the chunk).
// - The consumers multiply each stage with wgmma m64n64k16, 16 queued rows
//   deep a step: A = the feature tile, B = the g tile, both MN-major in shared
//   memory (the contraction runs over the tiles' rows), the 64 x 64 f32 sum
//   held in registers for the whole chunk; each stage's product goes to
//   fresh accumulators added to the sum in f32 (over a chunk's hundreds of
//   16-deep steps the tensor cores' own truncating accumulation missed the
//   1e-4 gate).  With MB or NB = 32 the tiles' other 32 columns are stale
//   and give rows or columns of the product that are not stored.
// The ordered second pass is unchanged.  What sets the pace on an H100
// (probe_kernels.py's cut-outs, PERF.md): the producers' issue of the row
// copies, then the stages' round trips.
constexpr int kDwSmRows = 64;      // queued valid rows a stage holds (the multiply's depth)
constexpr int kDwSmStages = 4;
constexpr int kDwSmProducers = 2;  // producer warps
constexpr int kDwSmThreads = 128 + 32 * kDwSmProducers;  // and one consumer warpgroup
constexpr int kDwSmAhead = 8;      // tiles whose indices the producer holds ahead
constexpr int kDwSmLag = 2;        // stages closed before the oldest is signalled
constexpr int kDwSmTile = kDwSmRows * 128;  // a 64 x 64 bf16 tile
constexpr int kDwSmBytes = kDwSmStages * 2 * kDwSmTile + 2 * kDwSmStages * 8 +
                           (kDwSmStages + 4) * 4 + kDwSmProducers * kDwRows * 8 + 1024;

template <int CUT = kCutNone>
__global__ void __launch_bounds__(kDwSmThreads, 3)
gather_dw_sm90_kernel(const bf16* __restrict__ feats, const int32_t* __restrict__ kmap,
                      const bf16* __restrict__ g, float* __restrict__ partial, int batch,
                      int c_in, int f_in, int k_vol, int c_out, int f_out, int mb, int nb) {
  constexpr int S = kDwSmStages;
  extern __shared__ uint8_t dw_sm90_raw[];
  uint8_t* smem = dw_sm90_raw + ((1024 - (sm90::smem_u32(dw_sm90_raw) & 1023)) & 1023);
  // stage s: feature tile at 2s, g tile at 2s + 1 (kDwSmTile bytes each)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * 2 * kDwSmTile);
  uint64_t* empty = full + S;
  int* hdr = reinterpret_cast<int*>(empty + S);  // rows of stage s, -1: no more
  // the producer warps' lists of a tile's valid rows (source, row), one each
  int2* lists_s = reinterpret_cast<int2*>(hdr + S + 4);

  const int k = blockIdx.x, chunk = blockIdx.y, n_chunks = gridDim.y;
  const int n_slices = f_out / nb;
  const int f0 = (blockIdx.z / n_slices) * mb, n0 = (blockIdx.z % n_slices) * nb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_per_cloud = (c_out + kDwRows - 1) / kDwRows;
  const int n_tiles = batch * tiles_per_cloud;
  const int n_steps = chunk < n_tiles ? (n_tiles - 1 - chunk) / n_chunks + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(full + s, kDwSmProducers);  // each producer warp, its copies landed
      sm90::mbar_init(empty + s, 4);  // the consumer warps
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 4) {
    // the producer warps, which walk the same tiles and stages, each copying
    // every other row of a tile.  Lane l owns rows l and l + 32 of each tile: it loads
    // their indices kDwSmAhead tiles ahead (the loop is unrolled by
    // kDwSmAhead, so no register holding a load in flight is copied: a copy
    // would wait for the load), and a ballot gives each valid row its place
    // in the queue.  The lanes then copy the tile's valid rows with a row's
    // pieces on neighbouring lanes (coalesced), from a list of (source,
    // row) in shared memory.
    const int qa = mb / 8, qg = nb / 8;  // 16-byte pieces of a row of feats, of g
    const int lg = max(qa, qg) <= 4 ? 2 : 3, q = lane & ((1 << lg) - 1);
    const int pw = warp - 4;  // this producer warp's share: rows pw, pw + kDwSmProducers, ...
    int2* list_s = lists_s + pw * kDwRows;
    // step i's tile as (cloud << 16) | tile of the cloud, walked by adding n_chunks
    int next_b = chunk / tiles_per_cloud, next_t = chunk - next_b * tiles_per_cloud;
    auto indices = [&](int i, int& r0, int& r1, int& bt) {
      const int row = next_t * kDwRows + lane;
      const int32_t* km = kmap + ((size_t)next_b * k_vol + k) * c_out;
      r0 = i < n_steps && row < c_out ? km[row] : c_in;
      r1 = i < n_steps && row + 32 < c_out ? km[row + 32] : c_in;
      bt = (next_b << 16) | next_t;
      for (next_t += n_chunks; next_t >= tiles_per_cloud; next_t -= tiles_per_cloud) ++next_b;
    };
    int ahead[kDwSmAhead][3];
#pragma unroll
    for (int a = 0; a < kDwSmAhead; ++a) indices(a, ahead[a][0], ahead[a][1], ahead[a][2]);
    uint32_t it = 0, signalled = 0;
    int n = 0;  // rows queued in the open stage `it`, whose buffer is free once n > 0
    // a stage is closed with its rows in the header and its copies committed
    // as one group; it is signalled (one arrival) once kDwSmLag later stages
    // are closed and its group has landed
    auto close = [&](int rows) {
      if (lane == 0 && pw == 0) hdr[it % S] = rows;
      sm90::cp_async_commit();
      ++it;
      if (it - signalled > kDwSmLag) {
        sm90::cp_async_wait<kDwSmLag>();
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(full + signalled % S);
        ++signalled;
      }
    };
    // piece q (this lane's) of a row of cloud b (feats row src, g row `row`)
    // to queue place pos of stage it (pos >= 64: of stage it + 1)
    auto copy_piece = [&](int b, int src, int row, int pos) {
      const uint32_t slot = (it + (pos >> 6)) % S, r = pos & 63;
      const uint32_t a_s = sm90::smem_u32(smem + 2 * slot * kDwSmTile);
      if (q < qa)
        sm90::cp_async_16(a_s + sm90::swz128(r, q),
                          feats + ((size_t)b * c_in + src) * f_in + f0 + 8 * q, 16);
      if (q < qg)
        sm90::cp_async_16(a_s + kDwSmTile + sm90::swz128(r, q),
                          g + ((size_t)b * c_out + row) * f_out + n0 + 8 * q, 16);
    };
    for (int i0 = 0; i0 < n_steps; i0 += kDwSmAhead)
#pragma unroll
    for (int a = 0; a < kDwSmAhead; ++a) {
      const int i = i0 + a;
      if (i >= n_steps) break;
      const int raw0 = ahead[a][0], raw1 = ahead[a][1], bt = ahead[a][2];
      indices(i + kDwSmAhead, ahead[a][0], ahead[a][1], ahead[a][2]);
      const bool v0 = (unsigned)raw0 < (unsigned)c_in, v1 = (unsigned)raw1 < (unsigned)c_in;
      const unsigned m0 = __ballot_sync(0xffffffffu, v0), m1 = __ballot_sync(0xffffffffu, v1);
      const int total = __popc(m0) + __popc(m1);
      if (total == 0) continue;
      if (n == 0) sm90::mbar_wait(empty + it % S, ((it / S) & 1) ^ 1);
      if (n + total > kDwSmRows)  // the tile spills into the next stage
        sm90::mbar_wait(empty + (it + 1) % S, (((it + 1) / S) & 1) ^ 1);
      if (CUT != kCutNoGather) {
        const unsigned below = (1u << lane) - 1;
        const int b = bt >> 16, row0 = (bt & 0xffff) * kDwRows;
        __syncwarp();  // the last tile's list is read
        if (v0) list_s[__popc(m0 & below)] = make_int2(raw0, row0 + lane);
        if (v1) list_s[__popc(m0) + __popc(m1 & below)] = make_int2(raw1, row0 + 32 + lane);
        __syncwarp();
        for (int j = (lane >> lg) * kDwSmProducers + pw; j < total;
             j += (32 >> lg) * kDwSmProducers) {
          const int2 e = list_s[j];
          copy_piece(b, e.x, e.y, n + j);
        }
      }
      n += total;
      if (n >= kDwSmRows) {
        close(kDwSmRows);
        n -= kDwSmRows;
      }
    }
    if (n > 0) {  // the chunk's last stage: zero its rows up to the multiply's next 16
      const uint32_t a_s = sm90::smem_u32(smem + 2 * (it % S) * kDwSmTile);
      for (int r = n + lane * kDwSmProducers + pw; r < ((n + 15) & ~15); r += 32 * kDwSmProducers)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q < qa) sm90::cp_async_16(a_s + sm90::swz128(r, q), feats, 0);
          if (q < qg) sm90::cp_async_16(a_s + kDwSmTile + sm90::swz128(r, q), feats, 0);
        }
      close(n);
    }
    sm90::cp_async_wait<0>();
    __syncwarp();
    for (; signalled < it; ++signalled)
      if (lane == 0) sm90::mbar_arrive(full + signalled % S);
    sm90::mbar_wait(empty + it % S, ((it / S) & 1) ^ 1);
    if (lane == 0) {
      if (pw == 0) hdr[it % S] = -1;
      sm90::mbar_arrive(full + it % S);
    }
    return;
  }

  // the consumer warpgroup: dW[k][f0 + m][n0 + c] for its 64 x 64 block;
  // each stage's product goes to fresh accumulators `part`, added to the
  // running sum in f32 (the tensor cores' own accumulation truncates: over a
  // chunk's hundreds of 16-deep steps that alone missed the 1e-4 gate)
  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
  for (uint32_t it = 0;; ++it) {
    const int slot = it % S;
    sm90::mbar_wait(full + slot, (it / S) & 1);
    const int rows = __shfl_sync(0xffffffffu, hdr[slot], 0);  // warp-uniform for the compiler
    if (rows < 0) break;
    sm90::fence_proxy_async();  // the cp.async rows, for wgmma's reads
    const uint8_t* a_s = smem + 2 * slot * kDwSmTile;
    if (CUT != kCutNoMma) {
      sm90::wgmma_fence();
      sm90::fence_regs(part);
#pragma unroll
      for (int ks = 0; ks < kDwSmRows / 16; ++ks)
        if (16 * ks < rows)
          sm90::wgmma_m64n64k16_ss_mn(part, sm90::smem_desc(a_s + 2048 * ks, 16, 1024),
                                      sm90::smem_desc(a_s + kDwSmTile + 2048 * ks, 16, 1024),
                                      ks > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + slot);
  }
  // acc[4j + 2h + e]: dW row f0 + 16 warp + lane / 4 + 8h, column n0 + 8j + 2 (lane % 4) + e
  float* out = partial + ((size_t)chunk * k_vol + k) * f_in * f_out;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * warp + gq + 8 * h;
    if (m >= mb) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < nb)
        *reinterpret_cast<float2*>(out + (size_t)(f0 + m) * f_out + n0 + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__global__ void gather_dw_reduce_kernel(const float4* __restrict__ partial,
                                        float4* __restrict__ out, int n_chunks, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = partial[i];
  for (int c = 1; c < n_chunks; ++c) {
    const float4 v = partial[(size_t)c * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

template <typename Kernel, typename T>
cudaError_t launch_partial(Kernel kernel, size_t smem, const T* feats, const int32_t* kmap,
                           const T* g, float* partial, int batch, int c_in, int f_in, int k_vol,
                           int c_out, int f_out, int n_chunks, int mb, int nb,
                           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(k_vol, n_chunks, (f_in / mb) * (f_out / nb));
  kernel<<<grid, kDwThreads, smem, stream>>>(feats, kmap, g, partial, batch, c_in, f_in, k_vol,
                                             c_out, f_out);
  return cudaGetLastError();
}

// the partial pass of a (MB, NB) slice, for f32 or bf16 operands
template <int MB, int NB>
cudaError_t launch_gather_dw_partial(const float* feats, const int32_t* kmap, const float* g,
                                     float* partial, int batch, int c_in, int f_in, int k_vol,
                                     int c_out, int f_out, int n_chunks, cudaStream_t stream) {
  return launch_partial(gather_dw_partial_kernel<MB, NB>, gather_dw_smem_bytes(MB, NB), feats,
                        kmap, g, partial, batch, c_in, f_in, k_vol, c_out, f_out, n_chunks, MB,
                        NB, stream);
}
#ifdef EGONN_PROBE_CUTS
// the cut-out `cut` (bf16.cuh) of the SM80 bf16 partial kernel and of the
// Hopper one, for probe_kernels.py
template <int MB, int NB>
auto gather_dw_bf16_body(int cut) {
  switch (cut) {
    case kCutNoMma: return gather_dw_bf16_partial_kernel<MB, NB, kCutNoMma>;
    case kCutNoGather: return gather_dw_bf16_partial_kernel<MB, NB, kCutNoGather>;
    case kCutNoMapScan: return gather_dw_bf16_partial_kernel<MB, NB, kCutNoMapScan>;
    default: return gather_dw_bf16_partial_kernel<MB, NB, kCutNone>;
  }
}
inline auto gather_dw_sm90_body(int cut) {
  switch (cut) {
    case kCutNoMma: return gather_dw_sm90_kernel<kCutNoMma>;
    case kCutNoGather: return gather_dw_sm90_kernel<kCutNoGather>;
    default: return gather_dw_sm90_kernel<kCutNone>;
  }
}
#else
template <int MB, int NB>
auto gather_dw_bf16_body(int) {
  return gather_dw_bf16_partial_kernel<MB, NB, kCutNone>;
}
inline auto gather_dw_sm90_body(int) { return gather_dw_sm90_kernel<kCutNone>; }
#endif
template <int MB, int NB>
cudaError_t launch_gather_dw_partial(const bf16* feats, const int32_t* kmap, const bf16* g,
                                     float* partial, int batch, int c_in, int f_in, int k_vol,
                                     int c_out, int f_out, int n_chunks, cudaStream_t stream,
                                     int cut) {
  return launch_partial(gather_dw_bf16_body<MB, NB>(cut), gather_dw_bf16_smem_bytes(MB, NB),
                        feats, kmap, g, partial, batch, c_in, f_in, k_vol, c_out, f_out,
                        n_chunks, MB, NB, stream);
}

// Both passes: the partial pass at slice (mb, nb), then the ordered sum.  bf16
// takes `body`: 1 the Hopper body (gather_dw_sm90_kernel), 0 the SM80 one, and
// `cut` kCutNone (or, built with EGONN_PROBE_CUTS, a cut-out of the body).
template <typename T>
int gather_dw(const T* feats, const int32_t* kmap, const T* g, float* partial, float* out,
              int batch, int c_in, int f_in, int k_vol, int c_out, int f_out, int mb, int nb,
              int n_chunks, int body, int cut, cudaStream_t st) {
  if (f_in % mb || f_out % nb || n_chunks <= 0 || (mb != 32 && mb != 64) ||
      (nb != 32 && nb != 64) || (body != 0 && body != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    if (mb == 64 && nb == 64)
      err = launch_gather_dw_partial<64, 64>(feats, kmap, g, partial, batch, c_in, f_in, k_vol,
                                             c_out, f_out, n_chunks, st);
    else if (mb == 64 && nb == 32)
      err = launch_gather_dw_partial<64, 32>(feats, kmap, g, partial, batch, c_in, f_in, k_vol,
                                             c_out, f_out, n_chunks, st);
    else if (mb == 32 && nb == 64)
      err = launch_gather_dw_partial<32, 64>(feats, kmap, g, partial, batch, c_in, f_in, k_vol,
                                             c_out, f_out, n_chunks, st);
    else
      err = launch_gather_dw_partial<32, 32>(feats, kmap, g, partial, batch, c_in, f_in, k_vol,
                                             c_out, f_out, n_chunks, st);
  } else if (body == 1) {
    auto kern = gather_dw_sm90_body(cut);
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(k_vol, n_chunks, (f_in / mb) * (f_out / nb));
    kern<<<grid, kDwSmThreads, kDwSmBytes, st>>>(feats, kmap, g, partial, batch, c_in, f_in,
                                                 k_vol, c_out, f_out, mb, nb);
    err = cudaGetLastError();
  } else if (mb == 64 && nb == 64) {
    err = launch_gather_dw_partial<64, 64>(feats, kmap, g, partial, batch, c_in, f_in, k_vol,
                                           c_out, f_out, n_chunks, st, cut);
  } else if (mb == 64 && nb == 32) {
    err = launch_gather_dw_partial<64, 32>(feats, kmap, g, partial, batch, c_in, f_in, k_vol,
                                           c_out, f_out, n_chunks, st, cut);
  } else if (mb == 32 && nb == 64) {
    err = launch_gather_dw_partial<32, 64>(feats, kmap, g, partial, batch, c_in, f_in, k_vol,
                                           c_out, f_out, n_chunks, st, cut);
  } else {
    err = launch_gather_dw_partial<32, 32>(feats, kmap, g, partial, batch, c_in, f_in, k_vol,
                                           c_out, f_out, n_chunks, st, cut);
  }
  if (err != cudaSuccess) return (int)err;
  const int n4 = k_vol * f_in * f_out / 4;
  gather_dw_reduce_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(out), n_chunks, n4);
  return (int)cudaGetLastError();
}

}  // namespace egonn

// f_in, f_out multiples of 32; (mb, nb) in {32, 64}^2 the dW slice of a block,
// mb | f_in and nb | f_out.  partial holds n_chunks * k_vol * f_in * f_out
// floats, out k_vol * f_in * f_out.  Returns cudaGetLastError() (or the first
// error of the attribute call or a launch).
extern "C" int egonn_gather_dw(const float* feats, const int32_t* kmap, const float* g,
                               float* partial, float* out, int batch, int c_in, int f_in,
                               int k_vol, int c_out, int f_out, int mb, int nb, int n_chunks,
                               void* stream) {
  return egonn::gather_dw(feats, kmap, g, partial, out, batch, c_in, f_in, k_vol, c_out, f_out,
                          mb, nb, n_chunks, 0, egonn::kCutNone, static_cast<cudaStream_t>(stream));
}

// The same with bf16 feats and g; partial and out f32.  `body`: 1 the Hopper
// body (gather_dw_sm90_kernel), 0 the SM80 one.
extern "C" int egonn_gather_dw_bf16(const egonn::bf16* feats, const int32_t* kmap,
                                    const egonn::bf16* g, float* partial, float* out, int batch,
                                    int c_in, int f_in, int k_vol, int c_out, int f_out, int mb,
                                    int nb, int n_chunks, int body, void* stream) {
  return egonn::gather_dw(feats, kmap, g, partial, out, batch, c_in, f_in, k_vol, c_out, f_out,
                          mb, nb, n_chunks, body, egonn::kCutNone,
                          static_cast<cudaStream_t>(stream));
}

#ifdef EGONN_PROBE_CUTS
// The cut-out `cut` (bf16.cuh) of bf16 body `body`, for probe_kernels.py
// (the Hopper body has no kCutNoMapScan).
extern "C" int egonn_gather_dw_bf16_cut(const egonn::bf16* feats, const int32_t* kmap,
                                        const egonn::bf16* g, float* partial, float* out,
                                        int batch, int c_in, int f_in, int k_vol, int c_out,
                                        int f_out, int mb, int nb, int n_chunks, int body,
                                        int cut, void* stream) {
  if (cut < egonn::kCutNone || cut > egonn::kCutNoMapScan ||
      (body == 1 && cut == egonn::kCutNoMapScan))
    return (int)cudaErrorInvalidValue;
  return egonn::gather_dw(feats, kmap, g, partial, out, batch, c_in, f_in, k_vol, c_out, f_out,
                          mb, nb, n_chunks, body, cut, static_cast<cudaStream_t>(stream));
}
#endif
