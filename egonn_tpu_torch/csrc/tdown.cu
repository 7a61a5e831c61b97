// Transposed k=2 s=2 down conv driven by the fine level's up map:
//   out[b, p] = epi( sum over fine i with up_parent[b, i] == p of
//                    feats[b, i] @ w[up_koffset[b, i]] )
//   epi(v)    = mask[b, p] ? relu?(v * scale + bias) : 0
// A parent outside [0, c_coarse) (a fine voxel whose parent was dropped by
// capacity) or a slot outside [0, 8) contributes nothing.
//
// Replaces egonn_tpu/sparse/banded.py::_pallas_banded_tdown (wrapper
// banded_tdown_pallas), which compares a window of up-parents against the
// coarse tile's rows to build a one-hot on the TPU.
//
// The fine table is key-sorted and a parent is its child's key halved, so
// the children of a tile of R coarse rows lie in a short run of fine rows.
// Two launches:
// 1. tdown_hull_kernel, a cluster of 8 blocks per cloud: per tile t the hull
//    [first, end) = [#i with cummax(parent)[i] < t R,
//                    #i with reverse-cummin(parent)[i] < (t + 1) R)
//    (rows without a parent count as -1 and +inf): every child of t lies
//    inside it, on any data.  This is tdown_layout's formula in banded.py
//    without its 128-row alignment and without a width cap, computed as the
//    first row whose parent is in a tile >= t and one past the last row
//    whose parent is in a tile <= t: each block reads an eighth of the rows
//    coalesced and folds each tile's first and last child into the
//    leader's shared memory (integer atomics over distributed shared
//    memory); the leader then takes a suffix min and a prefix max over the
//    tiles.  It lets the body launch at once (programmatic dependent
//    launch): the body's blocks set up their shared memory while the hulls
//    are computed and wait for them before reading one.
// 2. One of two bodies, a block of 256 threads per (32-column slice of
//    F_out, tile, cloud), both multiplying on the tensor cores in split TF32
//    (tf32x3.cuh) with each stage's products in fresh accumulators added in
//    f32, and applying the epilogue once, at the single store, to every row
//    of the tile, children or not:
//    - tdown_gather_kernel (128-row tiles; levels with many children per
//      tile, sweep in probe_kernels.py): from the hull's up map it fills
//      the tile's child table (slot, row) -> fine row in shared memory
//      (plain stores: a pair has one child), compacts each slot's children
//      in row order, and walks the (slot, 64 F_in columns) stages through
//      two cp.async buffers, each stage gathering its slot's child rows and
//      w[slot]'s rows; warps own 16 columns and every 4th 16-row MMA tile
//      and add their products into the tile's accumulator at the parents'
//      rows.  A parent has one child per slot, so within a stage each
//      (row, column) has one owner, and stages follow in slot order.
//    - tdown_kernel (tiles of 32 to 128 rows; deep levels with few
//      children, where the gathering body's 8 x F_in / 64 serial stages
//      cost more than the work): it streams the hull's fine rows
//      contiguously, rc rows by up to 128 F_in columns a stage, with all 8
//      slots' rows of w for its columns resident.  Warp s owns slot s: it
//      compacts the stage's rows of slot s whose parent is in the tile and
//      multiplies them (four 8-column MMA tiles at once, twelve independent
//      chains) into a per-row staging buffer; then each parent row adds its
//      children's results, slots in order, through a child table.
// No inversion scatter and no float atomics; the order of every sum is
// fixed, and the only atomics are the hull pass's integer min / max: equal
// inputs give bit-equal outputs.  A hull that spans the whole table
// (parents in no order) is slow and still exact.  Bound: the bytes of
// feats, the up map, w and out (the operations, three TF32 MMAs per
// product, are below them at EgoNN widths).
//
// bf16 features (T = bf16, the TPU kernel's numerics; bf16.cuh): the same
// hull launch, bodies and tilings, with bf16 rows in shared memory, w
// arriving rounded and transposed (W^T (8, F_out, F_in) in bf16, so that a
// B fragment is two 32-bit loads) and one mma.sync m16n8k16 per 16 deep per
// 8 columns; the gathering body's stage is 64 F_in columns as in f32 (the
// multiply is mma_stage_bf16, as in gather_mm.cuh).  The per-row results,
// the accumulator and the epilogue stay in f32; the store rounds once to
// bf16.  The streaming body's w tiles halve, so every tiling fits a block
// with two stage buffers (tdown_tiling_ok in sparse/kernels.py).
#include <cooperative_groups.h>

#include <type_traits>

#include "bf16.cuh"
#include "tf32x3.cuh"

namespace egonn {

constexpr int kThreads = 256;       // 8 warps, one per slot
constexpr int kMaxRowChunk = 128;   // fine rows per stage, at most (a row's index fits 8 bits)
constexpr int kGroup = 128;         // F_in columns of a stage, at most
constexpr int kChunk = 32;          // F_in columns per fresh MMA accumulator
constexpr int kSlots = 8;
constexpr int kSliceCols = 32;      // output columns of a block (NS)
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr int kHullThreads = 1024;
constexpr int kHullBlocks = 8;     // a cluster per cloud

// 4 bytes global -> shared (cached in L1)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// A body launched after the hull launch may start at once (programmatic
// dependent launch): it waits here, before it reads the hulls, until the
// hull launch has finished and its writes are visible.
__device__ __forceinline__ void wait_for_hulls() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// inclusive scan of v over the block's threads in order, with op; `total`
// gets op over all of them.  scratch: kHullThreads / 32 ints.
template <typename Op>
__device__ int block_scan(int v, Op op, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = op(v, a);
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  total = scratch[0];
  for (int w = 1; w < kHullThreads / 32; ++w) total = op(total, scratch[w]);
  for (int w = 0; w < warp; ++w) v = op(v, scratch[w]);
  __syncthreads();  // scratch is free again
  return v;
}

// One block per cloud.  first[t] = #i with cummax(parent)[i] < t R is the
// first fine row whose parent lies in a tile >= t, and end[t] = #i with
// reverse-cummin(parent)[i] < (t + 1) R is one past the last fine row whose
// parent lies in a tile <= t.  So: each tile's first and last child (rows
// read coalesced; of a warp's run of lanes whose parents share a tile, the
// first and the last lane take an integer atomic in shared memory), then a
// suffix min and a prefix max over the tiles.
__global__ void __cluster_dims__(kHullBlocks, 1, 1) __launch_bounds__(kHullThreads)
tdown_hull_kernel(const int32_t* __restrict__ up_parent, int2* __restrict__ hull, int c_fine,
                  int c_coarse, int rows, int n_tiles) {
  namespace cg = cooperative_groups;
  extern __shared__ int tile_s[];  // first child, then last child, per tile (the leader's)
  __shared__ int scratch[kHullThreads / 32];
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("griddepcontrol.launch_dependents;");  // the body may launch now
  const int rank = (int)cluster.block_rank(), cloud = blockIdx.x / kHullBlocks;
  int* first_s = tile_s;
  int* last_s = tile_s + n_tiles;
  const int tid = threadIdx.x, lane = tid & 31;
  const int32_t* par = up_parent + (size_t)cloud * c_fine;
  int2* hb = hull + (size_t)cloud * n_tiles;
  if (rank == 0) {
    for (int t = tid; t < n_tiles; t += kHullThreads) {
      first_s[t] = c_fine;
      last_s[t] = -1;
    }
  }
  cluster.sync();
  // this block's share of the rows, into the leader's tables
  int* lead_first = cluster.map_shared_rank(first_s, 0);
  int* lead_last = cluster.map_shared_rank(last_s, 0);
  const int seg = (c_fine + kHullBlocks - 1) / kHullBlocks;
  const int r0 = rank * seg, r1 = min(c_fine, r0 + seg);
  constexpr int kBatch = 4;  // rows a thread has in flight
  for (int base0 = r0 + tid - lane; base0 < r1; base0 += kBatch * kHullThreads) {
    int p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base0 + u * kHullThreads + lane;
      p[u] = i < r1 ? __ldg(par + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base0 + u * kHullThreads + lane;
      const int t = (unsigned)p[u] < (unsigned)c_coarse ? p[u] / rows : -1;
      // a run of lanes with one tile: its first lane and its last lane
      const int t_before = __shfl_up_sync(0xffffffffu, t, 1);
      const int t_after = __shfl_down_sync(0xffffffffu, t, 1);
      if (t >= 0 && (lane == 0 || t_before != t)) atomicMin(lead_first + t, i);
      if (t >= 0 && (lane == 31 || t_after != t)) atomicMax(lead_last + t, i);
    }
  }
  cluster.sync();
  if (rank != 0) return;
  auto max_op = [](int a, int b) { return max(a, b); };
  auto min_op = [](int a, int b) { return min(a, b); };
  int run = -1, total;
  for (int t0 = 0; t0 < n_tiles; t0 += kHullThreads) {  // tiles in order
    const int t = t0 + tid;
    const int v = max(run, block_scan(t < n_tiles ? last_s[t] : -1, max_op, scratch, total));
    if (t < n_tiles) hb[t].y = v + 1;
    run = max(run, total);
  }
  run = c_fine;
  for (int t0 = 0; t0 < n_tiles; t0 += kHullThreads) {  // tiles from the last
    const int t = n_tiles - 1 - (t0 + tid);
    const int v = min(run, block_scan(t >= 0 ? first_s[t] : c_fine, min_op, scratch, total));
    if (t >= 0) hb[t].x = v;
    run = min(run, total);
  }
}

// Per feature type in the bodies: the elements of a 16-byte copy, the MMA
// depth the columns are zero-padded to, and the extra row stride of the
// rows in shared memory (conflict-free fragment loads).
template <typename T>
struct TdElt;
template <>
struct TdElt<float> {
  static constexpr int kVec = 4, kDepth = 8, kPad = 4;
};
template <>
struct TdElt<bf16> {
  static constexpr int kVec = 8, kDepth = 16, kPad = 8;
};

// shared memory of a streaming tdown block: w (f32: 8 slots x gwp rows x
// NS, unpadded, columns swizzled; bf16: 8 slots x NS rows of W^T x gwp + 8),
// n_abuf stages of fine rows, the per-row results, the tile's accumulator,
// its child table, the slot lists and counts, the rows' parents and slots,
// the touched span
template <typename T>
inline size_t tdown_smem_bytes(int ns, int rows, int gwp, int rc, int n_abuf) {
  const size_t w = std::is_same_v<T, float> ? (size_t)kSlots * gwp * ns
                                            : (size_t)kSlots * ns * (gwp + 8);
  const size_t elems = w + (size_t)n_abuf * rc * (gwp + TdElt<T>::kPad);
  const size_t floats = (size_t)rc * (ns + 8) + (size_t)rows * (ns + 8);
  const size_t ints = (size_t)rows * kSlots + kSlots * rc + kSlots + (size_t)n_abuf * 2 * rc + 4;
  return sizeof(T) * elems + 4 * (floats + ints);
}

template <int NS, typename T>
__global__ void __launch_bounds__(kThreads)
tdown_kernel(const T* __restrict__ feats, const int32_t* __restrict__ up_parent,
             const int32_t* __restrict__ up_koffset, const int2* __restrict__ hull,
             const T* __restrict__ w, const float* __restrict__ scale,
             const float* __restrict__ bias, const uint8_t* __restrict__ mask,
             T* __restrict__ out, int c_fine, int f_in, int c_coarse, int f_out, int rows,
             int n_tiles, int gwp, int rc, int n_abuf, int relu) {
  using E = TdElt<T>;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int kLdV = NS + 8;  // shared row stride of the per-row results
  constexpr int kLdC = NS + 8;  // shared row stride of the accumulator
  constexpr int NT = NS / 8;    // 8-column MMA tiles of the slice
  constexpr int kPass = 4;      // ... a warp multiplies at once

  const int n_groups = (f_in + kGroup - 1) / kGroup;
  const int ld_a = gwp + E::kPad;  // shared row stride of the fine rows: conflict-free fragments
  const int ld_w = gwp + 8;        // bf16: shared row stride of W^T's rows
  extern __shared__ float4 smem4[];
  T* w_s = reinterpret_cast<T*>(smem4);                          // 8 slots of w
  T* a_s = w_s + (kF32 ? kSlots * gwp * NS : kSlots * NS * ld_w);  // n_abuf x rc x ld_a
  float* v_s = reinterpret_cast<float*>(a_s + n_abuf * rc * ld_a);  // rc x kLdV
  float* acc_s = v_s + rc * kLdV;                          // rows x kLdC
  int* child_s = reinterpret_cast<int*>(acc_s + rows * kLdC);  // rows x 8
  int* list_s = child_s + rows * kSlots;                   // 8 x rc
  int* cnt_s = list_s + kSlots * rc;                       // 8
  int* pk_s = cnt_s + kSlots;                              // n_abuf x (parents, slots)
  int* span_s = pk_s + n_abuf * 2 * rc;  // per row-chunk parity: tile rows touched, lo / hi

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * NS, tile = blockIdx.y, b = blockIdx.z;
  const int row0 = tile * rows;
  wait_for_hulls();
  const int2 hl = hull[(size_t)b * n_tiles + tile];
  const int first = hl.x, n_rows = max(0, hl.y - hl.x);
  const int n_sub = (n_rows + rc - 1) / rc;  // row chunks of the hull
  const int n_stages = n_sub * n_groups;                    // 0 for an empty tile
  const T* feats_b = feats + (size_t)b * c_fine * f_in;
  const int32_t* par_b = up_parent + (size_t)b * c_fine;
  const int32_t* ko_b = up_koffset + (size_t)b * c_fine;

  // the epilogue at the single store
  auto store = [&](int r, int q, float4 v) {
    const int row = row0 + r, cc = col0 + 4 * q;
    if (row >= c_coarse) return;
    store4(out + ((size_t)b * c_coarse + row) * f_out + cc,
           epi4(v, scale, bias, cc, relu, !mask || mask[(size_t)b * c_coarse + row]));
  };
  if (n_stages == 0) {  // no children: epi(0), without shared memory
    for (int e = tid; e < rows * (NS / 4); e += kThreads)
      store(e / (NS / 4), e % (NS / 4), make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }

  for (int e = tid; e < rows * kLdC; e += kThreads) acc_s[e] = 0.f;
  for (int e = tid; e < rows * kSlots; e += kThreads) child_s[e] = 0;  // no stamp
  if (tid < 4) span_s[tid] = tid % 2 ? -1 : rows;
  auto group_cols = [&](int gi) { return min(kGroup, f_in - gi * kGroup); };  // a multiple of kVec
  auto group_depth = [&](int gi) { return (group_cols(gi) + E::kDepth - 1) & ~(E::kDepth - 1); };

  // stage s: row chunk j = s / n_groups of the hull (rows j0 .. j0 + n - 1)
  // by F_in group gi = s % n_groups into buffer s % n_abuf, with the rows'
  // parents and slots at a row chunk's first stage, and w's rows of the
  // group (all slots, this block's columns; once when F_in is one group)
  auto load_stage = [&](int s) {
    const int j = s / n_groups, gi = s % n_groups, j0 = first + j * rc;
    const int n = min(rc, first + n_rows - j0);
    const int c0 = gi * kGroup, kc = group_cols(gi), qn = group_depth(gi) / E::kVec;
    T* a = a_s + (s % n_abuf) * rc * ld_a;
    for (int e = tid; e < n * qn; e += kThreads) {
      const int jj = e / qn, q = e - jj * qn;
      const bool ok = E::kVec * q < kc;  // past kc: zeros up to the MMA depth
      cp_async16(a + jj * ld_a + E::kVec * q,
                 ok ? feats_b + (size_t)(j0 + jj) * f_in + c0 + E::kVec * q : feats,
                 ok ? 16 : 0);
    }
    if (gi == 0) {
      int* pk = pk_s + (s % n_abuf) * 2 * rc;
      for (int e = tid; e < n; e += kThreads) {
        cp_async4(pk + e, par_b + j0 + e);
        cp_async4(pk + rc + e, ko_b + j0 + e);
      }
    }
    if (n_groups > 1 || s == 0) {
      if constexpr (kF32) {
        // w[k][c0 + rr][col0 + c] at w_s[(k gwp + rr) NS + (c ^ 8 (rr & 3))]:
        // a fragment's 4 rows x 8 columns fall on 32 banks
        const int per_slot = 4 * qn * (NS / 4);
        for (int e = tid; e < kSlots * per_slot; e += kThreads) {
          const int k = e / per_slot, rem = e - k * per_slot;
          const int rr = rem / (NS / 4), q = rem % (NS / 4);
          const bool ok = rr < kc;
          cp_async16(w_s + (k * gwp + rr) * NS + ((4 * q) ^ ((rr & 3) << 3)),
                     ok ? w + ((size_t)k * f_in + c0 + rr) * f_out + col0 + 4 * q : w,
                     ok ? 16 : 0);
        }
      } else {
        // W^T[k][col0 + n][c0 + c] at w_s[(k NS + n) ld_w + c]
        const int per_slot = NS * qn;
        for (int e = tid; e < kSlots * per_slot; e += kThreads) {
          const int k = e / per_slot, rem = e - k * per_slot;
          const int n = rem / qn, q = rem - n * qn;
          const bool ok = E::kVec * q < kc;
          cp_async16(w_s + (k * NS + n) * ld_w + E::kVec * q,
                     ok ? w + ((size_t)k * f_out + col0 + n) * f_in + c0 + E::kVec * q : w,
                     ok ? 16 : 0);
        }
      }
    }
  };

  const bool ahead = n_abuf == 2;  // the next stage loads while this one multiplies
  const int slot = warp;
  load_stage(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (!ahead && s > 0) {
      load_stage(s);
      cp_async_commit();
    }
    cp_async_wait<0>();  // stage s has landed
    __syncthreads();     // ... for every thread; stage s - 1 is done
    if (ahead && s + 1 < n_stages) {
      load_stage(s + 1);
      cp_async_commit();
    }
    const int j = s / n_groups, gi = s % n_groups, buf = s % n_abuf;
    const int stamp = (j + 1) << 8;
    if (gi == 0) {
      // 1. warp `slot`: the chunk's rows of its slot with a parent in the
      // tile, in row order; child_s[parent - row0][slot] = stamp | row
      const int* pk = pk_s + buf * 2 * rc;
      const int n = min(rc, n_rows - j * rc);
      int cnt = 0;
      for (int base = 0; base < n; base += 32) {
        const int jj = base + lane;
        bool v = false;
        int r = 0;
        if (jj < n) {
          const int p = pk[jj];
          r = p - row0;
          v = pk[rc + jj] == slot && (unsigned)r < (unsigned)rows && p < c_coarse;
        }
        const unsigned m = __ballot_sync(0xffffffffu, v);
        if (v) {
          list_s[slot * rc + cnt + __popc(m & ((1u << lane) - 1))] = jj;
          child_s[r * kSlots + slot] = stamp | jj;
        }
        cnt += __popc(m);
        const int r_lo = __reduce_min_sync(0xffffffffu, v ? r : rows);
        const int r_hi = __reduce_max_sync(0xffffffffu, v ? r : -1);
        if (lane == 0 && m) {
          atomicMin(span_s + 2 * (j & 1), r_lo);
          atomicMax(span_s + 2 * (j & 1) + 1, r_hi);
        }
      }
      if (lane == 0) cnt_s[slot] = cnt;
      __syncthreads();  // every slot's list and count
    }

    // 2. warp `slot` multiplies its rows by w[slot] as 16-row tiles on the
    // tensor cores, four 8-column tiles at a time: per 32 F_in columns the
    // products go into fresh accumulators (f32: three split-TF32 products
    // each, twelve independent MMA chains; bf16: one MMA per 16 deep),
    // summed in f32; each row's result goes to its own row of v_s (added
    // over F_in groups)
    {
      const T* a = a_s + buf * rc * ld_a;
      const int* lst = list_s + slot * rc;
      const T* ws = w_s + slot * (kF32 ? gwp * NS : NS * ld_w);
      const int kcp = group_depth(gi), cnt = cnt_s[slot];
      for (int m0 = 0; m0 < cnt; m0 += 16) {
        const bool v0 = m0 + g < cnt, v1 = m0 + g + 8 < cnt;
        const int j_0 = v0 ? lst[m0 + g] : 0, j_1 = v1 ? lst[m0 + g + 8] : 0;
        const T* p0 = a + j_0 * ld_a + (kF32 ? 1 : 2) * t4;
        const T* p1 = a + j_1 * ld_a + (kF32 ? 1 : 2) * t4;
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += kPass) {
          float sum[kPass][4];
#pragma unroll
          for (int e = 0; e < kPass * 4; ++e) sum[e / 4][e % 4] = 0.f;
          for (int k0 = 0; k0 < kcp; k0 += kChunk) {
            const int k1 = min(k0 + kChunk, kcp);
            if constexpr (kF32) {
              float part[kPass][3][4];
#pragma unroll
              for (int e = 0; e < kPass * 12; ++e) part[e / 12][(e / 4) % 3][e % 4] = 0.f;
              for (int kk = k0; kk < k1; kk += 8) {
                uint32_t a_hi[4], a_lo[4];
                split_tf32(v0 ? p0[kk] : 0.f, a_hi[0], a_lo[0]);
                split_tf32(v1 ? p1[kk] : 0.f, a_hi[1], a_lo[1]);
                split_tf32(v0 ? p0[kk + 4] : 0.f, a_hi[2], a_lo[2]);
                split_tf32(v1 ? p1[kk + 4] : 0.f, a_hi[3], a_lo[3]);
                const float* q = ws + (kk + t4) * NS;
#pragma unroll
                for (int nt = 0; nt < kPass; ++nt) {
                  const int c = ((n0 + nt) * 8 + g) ^ (t4 << 3);
                  uint32_t b_hi[2], b_lo[2];
                  split_tf32(q[c], b_hi[0], b_lo[0]);
                  split_tf32(q[4 * NS + c], b_hi[1], b_lo[1]);
                  mma_3xtf32_sets(part[nt], a_hi, a_lo, b_hi, b_lo);
                }
              }
#pragma unroll
              for (int nt = 0; nt < kPass; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  sum[nt][e] += part[nt][0][e] + (part[nt][1][e] + part[nt][2][e]);
            } else {
              float part[kPass][4];
#pragma unroll
              for (int e = 0; e < kPass * 4; ++e) part[e / 4][e % 4] = 0.f;
              for (int kk = k0; kk < k1; kk += 16) {
                const uint32_t af[4] = {v0 ? ld_pair(p0 + kk) : 0u, v1 ? ld_pair(p1 + kk) : 0u,
                                        v0 ? ld_pair(p0 + kk + 8) : 0u,
                                        v1 ? ld_pair(p1 + kk + 8) : 0u};
#pragma unroll
                for (int nt = 0; nt < kPass; ++nt) {
                  const T* q = ws + ((n0 + nt) * 8 + g) * ld_w + kk + 2 * t4;
                  const uint32_t bf[2] = {ld_pair(q), ld_pair(q + 8)};
                  mma_bf16(part[nt], af, bf);
                }
              }
#pragma unroll
              for (int nt = 0; nt < kPass; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) sum[nt][e] += part[nt][e];
            }
          }
#pragma unroll
          for (int nt = 0; nt < kPass; ++nt) {
            const int col = (n0 + nt) * 8 + 2 * t4;
            if (v0) {
              float2* d = reinterpret_cast<float2*>(v_s + j_0 * kLdV + col);
              const float2 o = gi == 0 ? make_float2(0.f, 0.f) : *d;
              *d = make_float2(o.x + sum[nt][0], o.y + sum[nt][1]);
            }
            if (v1) {
              float2* d = reinterpret_cast<float2*>(v_s + j_1 * kLdV + col);
              const float2 o = gi == 0 ? make_float2(0.f, 0.f) : *d;
              *d = make_float2(o.x + sum[nt][2], o.y + sum[nt][3]);
            }
          }
        }
      }
    }

    // 3. after the row chunk's last group: each tile row adds its children's
    // results, slots in order (one thread per row and 4 columns)
    if (gi == n_groups - 1) {
      __syncthreads();
      // only the tile rows the chunk's children touch; the next chunk's
      // span starts afresh
      const int r_lo = span_s[2 * (j & 1)], r_hi = span_s[2 * (j & 1) + 1];
      if (tid < 2) span_s[2 * ((j + 1) & 1) + tid] = tid ? -1 : rows;
      for (int e = tid; e < (r_hi - r_lo + 1) * (NS / 4); e += kThreads) {
        const int r = r_lo + e / (NS / 4), q = e % (NS / 4);
        const int* ch = child_s + r * kSlots;
        float4* dst = reinterpret_cast<float4*>(acc_s + r * kLdC + 4 * q);
        float4 acc = *dst;
        bool any = false;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const int c = ch[k];
          if ((c & ~255) == stamp) {
            const float4 v = *reinterpret_cast<const float4*>(v_s + (c & 255) * kLdV + 4 * q);
            acc.x += v.x;
            acc.y += v.y;
            acc.z += v.z;
            acc.w += v.w;
            any = true;
          }
        }
        if (any) *dst = acc;
      }
    }
    if (!ahead) __syncthreads();  // the buffers are free for the next stage's loads
  }
  __syncthreads();

  // 4. every row of the tile, children or not
  for (int e = tid; e < rows * (NS / 4); e += kThreads) {
    const int r = e / (NS / 4), q = e % (NS / 4);
    store(r, q, *reinterpret_cast<const float4*>(acc_s + r * kLdC + 4 * q));
  }
}

// The gathering body, for levels with many children per tile.  One block of
// 256 threads per (32-column slice, tile of 128 coarse rows, cloud); warp w
// owns the 16 columns w % 2 and every 4th 16-row MMA tile.
constexpr int kGatherRows = 128;
constexpr int kGatherChunk = 64;        // F_in columns of a stage, at most
constexpr int kRing = 2;                // stage buffers: one loads while one multiplies
constexpr int kLdW = kSliceCols + 8;    // f32: shared row stride of a stage's w rows

// shared row stride of a stage's gathered rows (bf16: and of its W^T rows)
template <typename T>
__host__ __device__ constexpr int gather_ld() {
  return kGatherChunk + TdElt<T>::kPad;
}
// a stage: the gathered rows, then w's chunk rows x 32 columns (f32) or
// W^T's 32 rows x the chunk (bf16)
template <typename T>
__host__ __device__ constexpr int gather_stage_elems() {
  return std::is_same_v<T, float> ? kGatherRows * gather_ld<T>() + kGatherChunk * kLdW
                                  : (kGatherRows + kSliceCols) * gather_ld<T>();
}

template <typename T>
inline size_t tdown_gather_smem_bytes() {
  return sizeof(T) * kRing * gather_stage_elems<T>() +
         4 * ((size_t)kGatherRows * (kSliceCols + 8) + (size_t)kSlots * kGatherRows +
              2 * kSlots + 1);
}

// two blocks an SM; without the bound ptxas gives the f32 body 64
// registers and spills
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
tdown_gather_kernel(const T* __restrict__ feats, const int32_t* __restrict__ up_parent,
                    const int32_t* __restrict__ up_koffset, const int2* __restrict__ hull,
                    const T* __restrict__ w, const float* __restrict__ scale,
                    const float* __restrict__ bias, const uint8_t* __restrict__ mask,
                    T* __restrict__ out, int c_fine, int f_in, int c_coarse, int f_out,
                    int n_tiles, int relu) {
  using E = TdElt<T>;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int NS = kSliceCols;
  constexpr int kLdG = gather_ld<T>();
  constexpr int kStage = gather_stage_elems<T>();
  constexpr int kLdC = NS + 8;  // shared row stride of the accumulator
  extern __shared__ float4 smem4[];
  T* stage_s = reinterpret_cast<T*>(smem4);                             // kRing x kStage
  float* acc_s = reinterpret_cast<float*>(stage_s + kRing * kStage);    // 128 x kLdC
  int* pair_s = reinterpret_cast<int*>(acc_s + kGatherRows * kLdC);     // 8 x 128
  int* cnt_s = pair_s + kSlots * kGatherRows;                           // 8
  int* list_s = cnt_s + kSlots;                                         // active slots, count

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int np = warp & 1, mg = warp >> 1;
  const int col0 = blockIdx.x * NS, tile = blockIdx.y, b = blockIdx.z;
  const int row0 = tile * kGatherRows;
  for (int e = tid; e < kGatherRows * kLdC; e += kThreads) acc_s[e] = 0.f;
  for (int e = tid; e < kSlots * kGatherRows; e += kThreads) pair_s[e] = -1;
  wait_for_hulls();
  const int2 hl = hull[(size_t)b * n_tiles + tile];
  const int first = hl.x, n_rows = max(0, hl.y - hl.x);
  const T* feats_b = feats + (size_t)b * c_fine * f_in;
  const int32_t* par_b = up_parent + (size_t)b * c_fine;
  const int32_t* ko_b = up_koffset + (size_t)b * c_fine;

  // the epilogue at the single store
  auto put = [&](int r, int q, float4 v) {
    const int row = row0 + r, cc = col0 + 4 * q;
    if (row >= c_coarse) return;
    store4(out + ((size_t)b * c_coarse + row) * f_out + cc,
           epi4(v, scale, bias, cc, relu, !mask || mask[(size_t)b * c_coarse + row]));
  };
  if (n_rows == 0) {  // no children: epi(0)
    for (int e = tid; e < kGatherRows * (NS / 4); e += kThreads)
      put(e / (NS / 4), e % (NS / 4), make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }

  // 1. the tile's child table from the hull's up map: pair_s[slot][row]
  __syncthreads();
  for (int i = tid; i < n_rows; i += kThreads) {
    const int p = __ldg(par_b + first + i), k = __ldg(ko_b + first + i);
    const int r = p - row0;
    if ((unsigned)r < (unsigned)kGatherRows && p < c_coarse && (unsigned)k < (unsigned)kSlots)
      pair_s[k * kGatherRows + r] = first + i;
  }
  __syncthreads();
  // 2. warp k: slot k's (row, child) pairs compacted in row order, in place:
  // (row << 24) | child
  {
    int* p = pair_s + warp * kGatherRows;
    int n = 0;
    for (int base = 0; base < kGatherRows; base += 32) {
      const int src = p[base + lane];
      const bool v = src >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, v);
      __syncwarp();
      if (v) p[n + __popc(m & ((1u << lane) - 1))] = ((base + lane) << 24) | src;
      n += __popc(m);
    }
    if (lane == 0) cnt_s[warp] = n;
  }
  __syncthreads();
  // 3. the slots with any child, in ascending order
  if (warp == 0) {
    const bool f = lane < kSlots && cnt_s[lane] > 0;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (f) list_s[__popc(m & ((1u << lane) - 1))] = lane;
    if (lane == 0) list_s[kSlots] = __popc(m);
  }
  __syncthreads();

  const int n_chunks = (f_in + kGatherChunk - 1) / kGatherChunk;
  const int n_stages = list_s[kSlots] * n_chunks;  // (slot, F_in chunk) pairs
  auto padded = [&](int c) {
    return (min(kGatherChunk, f_in - c * kGatherChunk) + E::kDepth - 1) & ~(E::kDepth - 1);
  };
  // stage s -> buffer `buf`: slot k = list_s[s / n_chunks] and chunk c =
  // s % n_chunks: the slot's children's chunk c gathered into rows 0 .. n-1,
  // and w[k]'s rows of chunk c in this block's columns (bf16: W^T's rows of
  // the columns, chunk c)
  auto load_stage = [&](int s, int buf) {
    const int k = list_s[s / n_chunks], c = s % n_chunks;
    T* a_s = stage_s + buf * kStage;
    T* b_s = a_s + kGatherRows * kLdG;
    const int c0 = c * kGatherChunk, kc = min(kGatherChunk, f_in - c0);
    const int qn = padded(c) / E::kVec;
    const int* pairs = pair_s + k * kGatherRows;
    for (int e = tid; e < cnt_s[k] * qn; e += kThreads) {
      const int j = e / qn, q = e - j * qn;
      const bool ok = E::kVec * q < kc;
      const T* src = feats_b + (size_t)(pairs[j] & 0xffffff) * f_in + c0 + E::kVec * q;
      cp_async16(a_s + j * kLdG + E::kVec * q, ok ? src : feats, ok ? 16 : 0);
    }
    if constexpr (kF32) {
      const float* w_k = w + ((size_t)k * f_in + c0) * f_out + col0;
      for (int e = tid; e < 4 * qn * (NS / 4); e += kThreads) {
        const int rr = e / (NS / 4), q = e % (NS / 4);
        const bool ok = rr < kc;
        cp_async16(b_s + rr * kLdW + 4 * q, ok ? w_k + (size_t)rr * f_out + 4 * q : w,
                   ok ? 16 : 0);
      }
    } else {
      const T* w_k = w + ((size_t)k * f_out + col0) * f_in + c0;
      for (int e = tid; e < NS * qn; e += kThreads) {
        const int n = e / qn, q = e - n * qn;
        const bool ok = E::kVec * q < kc;
        cp_async16(b_s + n * kLdG + E::kVec * q, ok ? w_k + (size_t)n * f_in + E::kVec * q : w,
                   ok ? 16 : 0);
      }
    }
  };
  // warp (np, mg): the stage's 16-row tiles mg, mg + 4, ... by its 16
  // columns np, added into the accumulator at the rows' places; within a
  // stage every (row, column) has one owner.  f32: six independent
  // accumulators (2 column tiles x 3 split products); bf16: mma_stage_bf16
  auto compute_stage = [&](int s, int buf) {
    const int k = list_s[s / n_chunks], c = s % n_chunks;
    const int n = cnt_s[k];
    const int* pairs = pair_s + k * kGatherRows;
    const T* a_s = stage_s + buf * kStage;
    const int kcp = padded(c);
    if constexpr (!kF32) {
      mma_stage_bf16(a_s, kLdG, a_s + (kGatherRows + np * 16) * kLdG, kLdG, pairs, n, kcp, mg,
                     4, acc_s, kLdC, np * 16);
    } else {
      const float* b_s = a_s + kGatherRows * kLdG + np * 16;
      for (int mt = mg; mt * 16 < n; mt += 4) {
        const int j0 = mt * 16 + g, j1 = j0 + 8;
        const bool v0 = j0 < n, v1 = j1 < n;  // rows past n hold stale data
        float part[2][3][4];
#pragma unroll
        for (int e = 0; e < 24; ++e) part[e / 12][(e / 4) % 3][e % 4] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < kcp; kk += 8) {
          uint32_t a_hi[4], a_lo[4], b_hi[2][2], b_lo[2][2];
          const float* p = a_s + j0 * kLdG + kk + t;
          split_tf32(v0 ? p[0] : 0.f, a_hi[0], a_lo[0]);
          split_tf32(v1 ? p[8 * kLdG] : 0.f, a_hi[1], a_lo[1]);
          split_tf32(v0 ? p[4] : 0.f, a_hi[2], a_lo[2]);
          split_tf32(v1 ? p[8 * kLdG + 4] : 0.f, a_hi[3], a_lo[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* q = b_s + (kk + t) * kLdW + nt * 8 + g;
            split_tf32(q[0], b_hi[nt][0], b_lo[nt][0]);
            split_tf32(q[4 * kLdW], b_hi[nt][1], b_lo[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_3xtf32_sets(part[nt], a_hi, a_lo, b_hi[nt], b_lo[nt]);
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
    }
  };
  // 4. the stages through a ring of kRing buffers, kRing - 1 in flight
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < n_stages) load_stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kRing - 2>();  // stage s has landed
    __syncthreads();             // ... for every thread; stage s - 1 is done
    if (s + kRing - 1 < n_stages) load_stage(s + kRing - 1, (s + kRing - 1) % kRing);
    cp_async_commit();
    compute_stage(s, s % kRing);
  }
  __syncthreads();
  // 5. every row of the tile, children or not
  for (int e = tid; e < kGatherRows * (NS / 4); e += kThreads)
    put(e / (NS / 4), e % (NS / 4),
        *reinterpret_cast<const float4*>(acc_s + (e / (NS / 4)) * kLdC + 4 * (e % (NS / 4))));
}

// The hull launch: (batch, n_tiles) int2 [first, end).  Returns its error
// (or cudaErrorInvalidValue where the tiles do not fit shared memory).
int launch_hulls(const int32_t* up_parent, int2* hull, int batch, int c_fine, int c_coarse,
                 int rows, cudaStream_t stream) {
  const int n_tiles = (c_coarse + rows - 1) / rows;
  const size_t smem = 2 * sizeof(int) * (size_t)n_tiles;
  if (rows <= 0 || c_fine <= 0 || c_coarse <= 0 || smem > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tdown_hull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tdown_hull_kernel<<<batch * kHullBlocks, kHullThreads, smem, stream>>>(
      up_parent, hull, c_fine, c_coarse, rows, n_tiles);
  return (int)cudaGetLastError();
}

// A body launch behind the hull launch, allowed to start before the hulls
// are done (it waits for them in wait_for_hulls).
template <typename... Params, typename... Args>
int launch_body(void (*kern)(Params...), dim3 grid, size_t smem, cudaStream_t stream,
                Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, static_cast<Params>(args)...);
}

// hull: (batch, ceil(c_coarse / rows)) int2 scratch.  gather: the
// gathering body (rows 128, rc unused), else the streaming body (rows and rc
// 32, 64 or 128).  f_out a multiple of 32 (the column slice), f_in of 4
// (f32) or 8 (bf16, w as W^T (8, f_out, f_in)).  Two launches; returns the
// first error (or the attribute call's).
template <typename T>
int launch_tdown(const T* feats, const int32_t* up_parent, const int32_t* up_koffset,
                 const T* w, const float* scale, const float* bias, const uint8_t* mask,
                 int32_t* hull, T* out, int batch, int c_fine, int f_in, int c_coarse,
                 int f_out, int rows, int rc, int gather, int relu, cudaStream_t st) {
  constexpr int cols = kSliceCols;
  if ((rows != 32 && rows != 64 && rows != 128) || (gather && rows != kGatherRows) ||
      f_out % cols || f_in % TdElt<T>::kVec || f_in <= 0 || c_fine <= 0 || c_coarse <= 0 ||
      c_fine >= (1 << 24))
    return (int)cudaErrorInvalidValue;
  int2* hull2 = reinterpret_cast<int2*>(hull);
  const int n_tiles = (c_coarse + rows - 1) / rows;
  const dim3 grid(f_out / cols, n_tiles, batch);
  if (gather) {
    const size_t smem = tdown_gather_smem_bytes<T>();
    int err = launch_hulls(up_parent, hull2, batch, c_fine, c_coarse, rows, st);
    if (err != 0) return err;
    return launch_body(tdown_gather_kernel<T>, grid, smem, st, feats, up_parent, up_koffset,
                       (const int2*)hull2, w, scale, bias, mask, out, c_fine, f_in, c_coarse,
                       f_out, n_tiles, relu);
  }
  const int n_groups = (f_in + kGroup - 1) / kGroup;
  constexpr int depth = TdElt<T>::kDepth;
  const int gwp = n_groups > 1 ? kGroup : (f_in + depth - 1) & ~(depth - 1);
  if (rc != 32 && rc != 64 && rc != kMaxRowChunk) return (int)cudaErrorInvalidValue;
  // two stage buffers (the next stage loads while one multiplies) where
  // they fit and w stays (one F_in group)
  const int n_abuf =
      n_groups == 1 && tdown_smem_bytes<T>(cols, rows, gwp, rc, 2) <= kMaxSmem ? 2 : 1;
  const size_t smem = tdown_smem_bytes<T>(cols, rows, gwp, rc, n_abuf);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int err = launch_hulls(up_parent, hull2, batch, c_fine, c_coarse, rows, st);
  if (err != 0) return err;
  return launch_body(tdown_kernel<cols, T>, grid, smem, st, feats, up_parent, up_koffset,
                     (const int2*)hull2, w, scale, bias, mask, out, c_fine, f_in, c_coarse,
                     f_out, rows, n_tiles, gwp, rc, n_abuf, relu);
}

}  // namespace egonn

// The hulls alone, for tests and launch sweeps: hull (batch, ceil(c_coarse /
// rows), 2) int32.
extern "C" int egonn_tdown_hulls(const int32_t* up_parent, int32_t* hull, int batch, int c_fine,
                                 int c_coarse, int rows, void* stream) {
  return egonn::launch_hulls(up_parent, reinterpret_cast<int2*>(hull), batch, c_fine, c_coarse,
                             rows, static_cast<cudaStream_t>(stream));
}

// f32 features, weights and output (split TF32)
extern "C" int egonn_tdown(const float* feats, const int32_t* up_parent,
                           const int32_t* up_koffset, const float* w, const float* scale,
                           const float* bias, const uint8_t* mask, int32_t* hull, float* out,
                           int batch, int c_fine, int f_in, int c_coarse, int f_out, int rows,
                           int rc, int gather, int relu, void* stream) {
  return egonn::launch_tdown(feats, up_parent, up_koffset, w, scale, bias, mask, hull, out, batch,
                             c_fine, f_in, c_coarse, f_out, rows, rc, gather, relu,
                             static_cast<cudaStream_t>(stream));
}

// bf16 features and output, w_t = W^T (8, f_out, f_in) rounded to bf16
extern "C" int egonn_tdown_bf16(const egonn::bf16* feats, const int32_t* up_parent,
                                const int32_t* up_koffset, const egonn::bf16* w_t,
                                const float* scale, const float* bias, const uint8_t* mask,
                                int32_t* hull, egonn::bf16* out, int batch, int c_fine, int f_in,
                                int c_coarse, int f_out, int rows, int rc, int gather, int relu,
                                void* stream) {
  return egonn::launch_tdown(feats, up_parent, up_koffset, w_t, scale, bias, mask, hull, out,
                             batch, c_fine, f_in, c_coarse, f_out, rows, rc, gather, relu,
                             static_cast<cudaStream_t>(stream));
}
