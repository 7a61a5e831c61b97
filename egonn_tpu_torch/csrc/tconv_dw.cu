// Weight gradient of the transposed k=2 s=2 convolution (tconv.cu):
//
//   dW[k] = sum_b sum over the fine rows i of slot k with a parent of
//           feats[b, up_parent[b, i], :]^T g[b, i, :]                (F_in x F_out)
//
// feats the coarse level's features, g the cotangent on the fine level.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA
// (egonn_tpu/sparse/conv.py::sparse_tconv2x2_vjp's backward, 8 slot-masked
// einsums).  Its torch form on the card gathered every fine row's parent
// and, for each of the 8 slots, wrote a slot-masked f32 copy of them and
// multiplied it by g over every capacity row on the f32 SIMT GEMM: 8 times
// the useful products, 8 copies written and read, g read 8 times.
//
// Design.  Each valid fine row lies in exactly one slot, so dW[k] is a
// dense product over the rows of slot k alone, which the slot order
// (`kernels.slot_order`, the one the forward ran over) lists: each cloud's
// segment k is a dense list of slot-k rows.  The segments of all clouds are
// walked as one list, so a 64-row tile may span clouds and only the last
// tile of a slot is partly empty; segment 8 (no parent, padding) is never
// read.  A block first scans the clouds' segment sizes into shared memory
// (the host reads no size); a tile row finds its cloud by a binary search
// there, then reads its fine row from the order and the row's parent from
// the up map.  (The other route, the coarse level's kmap_down with each
// coarse row's slot-k child compacted by a ballot, is gather_dw with its
// operands swapped: 1.3-2.2 times slower at every measured call on an
// H100, its maps 20-50% full, PERF.md.)
//
// Frame (gather_dw.cu's f32 partial pass, with both operands gathered).
// Grid (8 slots, n_chunks, slices), 128 threads: block (k, c, s) owns an
// MB x NB slice s of dW[k] (MB, NB = 32 or 64) and walks the tiles c,
// c + n_chunks, ... of its slot.  Each step's rows are fetched two steps
// before they are copied (the order one step before the parent, so each
// dependent load has a whole step to land), counted with a ballot, and
// each row's MB gathered feature columns and NB columns of g are copied by
// cp.async through a ring of three shared-memory buffers, two tiles in
// flight while one multiplies.
// The 2 x 2 warps add A^T (MB x n) . G (n x NB), depth n rounded up to 8,
// on the tensor cores, mma.sync m16n8k8 in split TF32 (tf32x3.cuh: f32
// accuracy), into fresh accumulators added to the running sums in f32 after
// each tile.  The block writes its slice of partial[c, k];
// tconv_dw_reduce_kernel sums the chunks in index order.  No float atomics
// and a fixed summation order: equal inputs give bit-equal outputs.
//
// Bound: bytes of feats, the up map, g and dW, each moved once, against
// 2 x rows x F_in x F_out f32 operations at three TF32 MMAs each (165
// TFLOP/s on an H100): at 256 x 256 wide the operations, at 32-64 wide the
// bytes.  The tiles' row gathers and the dependent index loads are the
// latency the ring and the fetch pipeline hide.
//
// Shapes: F_in and F_out multiples of MB and NB, B up to the shared memory
// that the scan of the segment sizes takes (two ints a cloud, ~15,000
// clouds at 64 x 64); the entry point returns cudaErrorInvalidValue
// otherwise.
#include "tf32x3.cuh"

namespace egonn {

constexpr int kTdRows = 64;      // rows of a tile
constexpr int kTdThreads = 128;  // 2 x 2 warps over the block's dW slice
constexpr int kTdStages = 3;     // ring of tiles in shared memory: 2 in flight
constexpr int kTdSegs = 9;       // the slot order's segments: slots 0..7, then no parent
constexpr int kTdMaxSmem = 227 * 1024;

inline size_t tconv_dw_smem_bytes(int mb, int nb, int batch) {
  return sizeof(float) * kTdStages * (size_t)kTdRows * (mb + 8 + nb + 8) +
         sizeof(int) * (kTdStages + 1) * (kTdThreads / 32) +
         sizeof(int) * (2 * (size_t)batch + 1);
}

// One tile row: its cloud, fine row (-1: none) and the fine row's parent
// (-1: not read yet), read in two steps.
struct TdRow {
  int b, a, f;
};

template <int MB, int NB>
__global__ void __launch_bounds__(kTdThreads)
tconv_dw_partial_kernel(const float* __restrict__ feats, const int32_t* __restrict__ up_parent,
                        const int32_t* __restrict__ order, const int32_t* __restrict__ seg,
                        const float* __restrict__ g, float* __restrict__ partial, int batch,
                        int c_coarse, int c_fine, int f_in, int f_out) {
  constexpr int kLdA = MB + 8, kLdG = NB + 8;  // shared row strides (floats)
  constexpr int kStage = kTdRows * (kLdA + kLdG);
  constexpr int MT = MB / 32, NT = NB / 16;    // MMA tiles per warp (MB/2 x NB/2)
  constexpr int kWarps = kTdThreads / 32;

  extern __shared__ float4 td_smem4[];
  float* stage_s = reinterpret_cast<float*>(td_smem4);  // kTdStages x kStage
  // valid rows per warp's 16 rows, for steps i mod (kTdStages + 1)
  int* cnt_s = reinterpret_cast<int*>(stage_s + kTdStages * kStage);
  // slot k's rows in the clouds before b (batch + 1), and each cloud's
  // segment start less them (batch)
  int* pre_s = cnt_s + (kTdStages + 1) * kWarps;
  int* start_s = pre_s + batch + 1;

  const int k = blockIdx.x, chunk = blockIdx.y, n_chunks = gridDim.y;
  const int n_slices = f_out / NB;
  const int f0 = (blockIdx.z / n_slices) * MB, n0 = (blockIdx.z % n_slices) * NB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int r = tid >> 1, half = tid & 1;  // the row this thread fetches

  // exclusive scan of the clouds' slot-k rows, kTdThreads clouds a round
  {
    int carry = 0;
    for (int b0 = 0; b0 < batch; b0 += kTdThreads) {
      const int b = b0 + tid;
      const int lo = b < batch ? seg[(size_t)b * (kTdSegs + 1) + k] : 0;
      const int n_b = b < batch ? seg[(size_t)b * (kTdSegs + 1) + k + 1] - lo : 0;
      int v = n_b;  // the warp's inclusive scan
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      if (lane == 31) cnt_s[warp] = v;
      __syncthreads();
      int before = carry;
      for (int w = 0; w < warp; ++w) before += cnt_s[w];
      if (b < batch) {
        pre_s[b + 1] = before + v;
        start_s[b] = lo - (before + v - n_b);  // order position = start_s[b] + entry
      }
      carry += cnt_s[0] + cnt_s[1] + cnt_s[2] + cnt_s[3];
      __syncthreads();  // every thread has read cnt_s
    }
    if (tid == 0) pre_s[0] = 0;
    __syncthreads();
  }
  const int total = pre_s[batch];  // slot k's rows
  const int n_tiles = (total + kTdRows - 1) / kTdRows;
  const int n_steps = chunk < n_tiles ? (n_tiles - 1 - chunk) / n_chunks + 1 : 0;

  // this thread's row of step i, first half: entry e of the slot's list
  // gives its cloud and, from the order, its fine row
  auto fetch = [&](int i) -> TdRow {
    TdRow x{0, -1, -1};
    if (i >= n_steps) return x;
    const int e = (chunk + i * n_chunks) * kTdRows + r;
    if (e < total) {
      int lo = 0, hi = batch;  // pre_s[lo] <= e < pre_s[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pre_s[mid] <= e) lo = mid;
        else hi = mid;
      }
      x.b = lo;
      x.f = order[(size_t)lo * c_fine + start_s[lo] + e];
    }
    return x;
  };
  // second half: the fine row's parent, from the up map
  auto resolve = [&](TdRow x) -> TdRow {
    if ((unsigned)x.f < (unsigned)c_fine) x.a = up_parent[(size_t)x.b * c_fine + x.f];
    return x;
  };

  // Step i's valid rows (all but past the list's end, or a parent outside
  // the coarse level) are compacted, in row order, into rows 0 .. n-1 of
  // its buffer: the row's place is the valid rows before it, counted per
  // warp (16 rows each) with a ballot and summed over the warps in cnt_s.
  // Called by all threads between the copies' barrier and their issue.
  auto count_tile = [&](TdRow x, int i) {
    const bool v = (unsigned)x.a < (unsigned)c_coarse && (unsigned)x.f < (unsigned)c_fine;
    const unsigned m = __ballot_sync(0xffffffffu, v && !half);  // even lanes: one per row
    if (lane == 0) cnt_s[(i % (kTdStages + 1)) * kWarps + warp] = __popc(m);
    return __popc(m & ((1u << (lane & ~1)) - 1));  // valid rows before mine in my warp
  };
  // Copies step i's valid rows to their places (nothing for a step without
  // one).  Called by all threads (the shuffles need the whole warp): the
  // lanes of a warp copy its 16 rows with a row's 16-byte pieces on
  // neighbouring lanes, each row's source rows and place shuffled from the
  // lane that fetched them (-1: no row).
  auto load_tile = [&](TdRow x, int i, int pos) {
    const int* cnt = cnt_s + (i % (kTdStages + 1)) * kWarps;
    if (cnt[0] + cnt[1] + cnt[2] + cnt[3] == 0) return;  // block-uniform
    for (int w = 0; w < warp; ++w) pos += cnt[w];
    float* a_s = stage_s + (i % kTdStages) * kStage;
    float* g_s = a_s + kTdRows * kLdA;
    const bool v = (unsigned)x.a < (unsigned)c_coarse && (unsigned)x.f < (unsigned)c_fine;
    const int a_row = v ? x.b * c_coarse + x.a : -1, g_row = v ? x.b * c_fine + x.f : -1;
    constexpr int PA = MB / 4, PG = NB / 4;  // 16-byte pieces per row
#pragma unroll
    for (int jr0 = 0; jr0 < 16; jr0 += 32 / PA) {
      const int jr = jr0 + lane / PA, q = lane % PA;
      const int src = __shfl_sync(0xffffffffu, a_row, 2 * jr);
      const int at = __shfl_sync(0xffffffffu, pos, 2 * jr);
      if (src >= 0) cp_async16(a_s + at * kLdA + 4 * q, feats + (size_t)src * f_in + f0 + 4 * q, 16);
    }
#pragma unroll
    for (int jr0 = 0; jr0 < 16; jr0 += 32 / PG) {
      const int jr = jr0 + lane / PG, q = lane % PG;
      const int src = __shfl_sync(0xffffffffu, g_row, 2 * jr);
      const int at = __shfl_sync(0xffffffffu, pos, 2 * jr);
      if (src >= 0) cp_async16(g_s + at * kLdG + 4 * q, g + (size_t)src * f_out + n0 + 4 * q, 16);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // step i's n compacted rows: A^T (MB x n) . G (n x NB), depth n rounded up
  // to the MMA's 8 (the rows past n hold stale data and are read as zero)
  auto compute_tile = [&](int i) {
    const int* cnt = cnt_s + (i % (kTdStages + 1)) * kWarps;
    const int n = cnt[0] + cnt[1] + cnt[2] + cnt[3];
    if (n == 0) return;
    const float* a_s = stage_s + (i % kTdStages) * kStage + wm * (MB / 2);
    const float* g_s = stage_s + (i % kTdStages) * kStage + kTdRows * kLdA + wn * (NB / 2);
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

  // The steps through a ring of kTdStages buffers: step i + kTdStages - 1 is
  // copied into the buffer that step i - 1 left, its rows resolved during
  // step i - 1 and fetched during step i - 2.  Its row counts go to slot
  // (i + kTdStages - 1) mod (kTdStages + 1) before the barrier, never the
  // slot that step i - 1, still computing on slower warps, reads.
  TdRow cur = resolve(fetch(0));
  TdRow pend = fetch(1);
  for (int j = 0; j < kTdStages - 1; ++j) {
    const TdRow next = resolve(pend);
    pend = fetch(j + 2);
    const int pos = count_tile(cur, j);
    __syncthreads();
    load_tile(cur, j, pos);
    cp_async_commit();
    cur = next;
  }
  for (int i = 0; i < n_steps; ++i) {
    const TdRow next = resolve(pend);       // step i + kTdStages
    pend = fetch(i + kTdStages + 1);
    const int pos = count_tile(cur, i + kTdStages - 1);
    cp_async_wait<kTdStages - 2>();  // step i has landed
    __syncthreads();  // for every thread, with all counts; step i - 1 is done
    load_tile(cur, i + kTdStages - 1, pos);
    cp_async_commit();
    compute_tile(i);
    cur = next;
  }

  float* out = partial + ((size_t)chunk * 8 + k) * f_in * f_out;
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

__global__ void tconv_dw_reduce_kernel(const float4* __restrict__ partial,
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

template <int MB, int NB>
cudaError_t launch_tconv_dw_partial(const float* feats, const int32_t* up_parent,
                                    const int32_t* order, const int32_t* seg, const float* g,
                                    float* partial, int batch, int c_coarse, int c_fine,
                                    int f_in, int f_out, int n_chunks, cudaStream_t st) {
  const size_t smem = tconv_dw_smem_bytes(MB, NB, batch);
  if (smem > (size_t)kTdMaxSmem) return cudaErrorInvalidValue;
  auto kernel = tconv_dw_partial_kernel<MB, NB>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(8, n_chunks, (f_in / MB) * (f_out / NB));
  kernel<<<grid, kTdThreads, smem, st>>>(feats, up_parent, order, seg, g, partial, batch,
                                         c_coarse, c_fine, f_in, f_out);
  return cudaGetLastError();
}

// Both passes: the partial pass at slice (mb, nb), then the ordered sum.
int tconv_dw(const float* feats, const int32_t* up_parent, const int32_t* order,
             const int32_t* seg, const float* g, float* partial, float* out, int batch,
             int c_coarse, int c_fine, int f_in, int f_out, int mb, int nb, int n_chunks,
             cudaStream_t st) {
  if ((mb != 32 && mb != 64) || (nb != 32 && nb != 64) || f_in <= 0 || f_out <= 0 ||
      f_in % mb || f_out % nb || n_chunks <= 0 || batch < 0 || c_coarse < 0 || c_fine < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (mb == 64 && nb == 64)
    err = launch_tconv_dw_partial<64, 64>(feats, up_parent, order, seg, g, partial, batch,
                                          c_coarse, c_fine, f_in, f_out, n_chunks, st);
  else if (mb == 64)
    err = launch_tconv_dw_partial<64, 32>(feats, up_parent, order, seg, g, partial, batch,
                                          c_coarse, c_fine, f_in, f_out, n_chunks, st);
  else if (nb == 64)
    err = launch_tconv_dw_partial<32, 64>(feats, up_parent, order, seg, g, partial, batch,
                                          c_coarse, c_fine, f_in, f_out, n_chunks, st);
  else
    err = launch_tconv_dw_partial<32, 32>(feats, up_parent, order, seg, g, partial, batch,
                                          c_coarse, c_fine, f_in, f_out, n_chunks, st);
  if (err != cudaSuccess) return (int)err;
  const int n4 = 8 * f_in * f_out / 4;
  tconv_dw_reduce_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(out), n_chunks, n4);
  return (int)cudaGetLastError();
}

}  // namespace egonn

// feats (batch, c_coarse, f_in) and g (batch, c_fine, f_out) f32; up_parent
// and order (batch, c_fine), seg (batch, 10) int32 (`kernels.slot_order`);
// partial n_chunks x 8 x f_in x f_out and out 8 x f_in x f_out floats;
// (mb, nb) in {32, 64}^2 the dW slice of a block, mb | f_in and nb | f_out;
// all contiguous and 16-byte aligned.  Returns cudaGetLastError() (or the
// first error).
extern "C" int egonn_tconv_dw(const float* feats, const int32_t* up_parent, const int32_t* order,
                              const int32_t* seg, const float* g, float* partial, float* out,
                              int batch, int c_coarse, int c_fine, int f_in, int f_out, int mb,
                              int nb, int n_chunks, void* stream) {
  return egonn::tconv_dw(feats, up_parent, order, seg, g, partial, out, batch, c_coarse, c_fine,
                         f_in, f_out, mb, nb, n_chunks, static_cast<cudaStream_t>(stream));
}
