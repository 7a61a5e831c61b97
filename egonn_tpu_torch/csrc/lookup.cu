// Sorted-key lookup: for every query of a (cloud, kernel offset, output
// voxel), its position in the cloud's sorted key table, or c_in where the key
// is absent or the query is MAXKEY (invalid).  Builds the k=2 s=2 down maps
// of levels whose finer level records no up map.
//
// Replaces egonn_tpu/sparse/banded.py::_pallas_banded_lookup (wrapper
// banded_lookup), which compares each 128-query tile of an offset against one
// window row of the table on the TPU's vector unit, after a pre-pass that
// picks the rows, and falls back to a bucketed lookup where a tile's queries
// do not fit their window.
//
// One `__global__` with two query sources:
// (a) given queries (B, K, C_out), the TPU kernel's signature;
// (b) down mode: the kernel forms each query itself from the coarse level's
//     sorted keys (B, C_out): unpack under the coarse level's packing, the 8
//     children 2 * c + d (d in C order over (dx, dy, dz), dz fastest),
//     range-checked and packed under the fine level's packing, MAXKEY where
//     the coarse key is MAXKEY (packing.py::kmap_queries with k = s = 2).
//     No (B, 8, C_out) query tensor is written.
// One launch serves several levels (each a table, a query source and an
// output): their descriptors travel by value in the kernel's parameters, so
// the launch needs no host-to-device copy and no synchronization.
//
// The search is a chain of dependent loads: one thread per query through
// the global table waits on ~14 L2 round trips.  But a sorted coarse level's
// children are sorted for each offset (doubling a packed key keeps its
// order), so all the children of a tile of R coarse rows lie in one short
// run of the fine table.  Design: one block of 256 threads per (level,
// cloud, tile of R rows), all K offsets (R = 256 in down mode: 8 queries a
// thread).
// 1. The tile's queries are formed (or read) and a block reduction gives
//    the min and max of the valid ones.  A tile without one writes c_in.
// 2. Every thread reads one of 256 evenly spaced table rows (step
//    ceil(C_in / 256)); two block counts of the rows below the min and below
//    the max bound the run [lo, hi] in one L2 round trip (zrun.cu's probes).
// 3. table[lo, hi] is copied into shared memory with cp.async; each query
//    is searched there and compared; positions are written coalesced along
//    C_out for each offset.
// 4. A tile whose run does not fit `slice_cap` rows searches the global
//    table, narrowed to [lo, hi]: exact and slower; `overflow` counts such
//    blocks.
// Correctness never depends on the queries being sorted; only speed does.
// Bound: the bytes of the table, the query source (queries, or the coarse
// keys in down mode) and the positions.
#include <cuda_runtime.h>
#include <stdint.h>

namespace egonn {

constexpr int32_t kMaxKey = 2147483647;
constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;
constexpr int kMaxSlice = 56 * 1024;  // rows: 224 KB of dynamic shared memory
constexpr int kMaxPer = 8;            // queries per thread: a tile holds K x rows <= 2048

struct LookupLevel {
  const int32_t* table;  // (batch, c_in) sorted keys, MAXKEY padded
  const int32_t* src;    // (batch, k, c_out) queries, or (batch, c_out) coarse keys
  int32_t* pos;          // (batch, k, c_out)
  int c_in, c_out, k;
  int tiles;        // ceil(c_out / rows)
  int first_block;  // blocks of the levels before this one
  int bits_c[3], off_c[3];  // down mode: the coarse level's packing
  int bits_f[3], off_f[3];  // ... and the fine level's
};

struct LookupArgs {
  LookupLevel lv[kMaxLevels];
  int n_levels, rows, slice_cap, down;
  int* overflow;
};

// the packed key of child d of coarse key ck (down mode)
__device__ __forceinline__ int32_t child_key(const LookupLevel& L, int32_t ck, int d) {
  if (ck == kMaxKey) return kMaxKey;
  const int cz = (ck & ((1 << L.bits_c[2]) - 1)) - L.off_c[2];
  const int cy = ((ck >> L.bits_c[2]) & ((1 << L.bits_c[1]) - 1)) - L.off_c[1];
  const int cx = ((ck >> (L.bits_c[1] + L.bits_c[2])) & ((1 << L.bits_c[0]) - 1)) - L.off_c[0];
  const int x = 2 * cx + ((d >> 2) & 1) + L.off_f[0];
  const int y = 2 * cy + ((d >> 1) & 1) + L.off_f[1];
  const int z = 2 * cz + (d & 1) + L.off_f[2];
  if (x < 0 || x >= (1 << L.bits_f[0]) || y < 0 || y >= (1 << L.bits_f[1]) || z < 0 ||
      z >= (1 << L.bits_f[2]))
    return kMaxKey;
  return (x << (L.bits_f[1] + L.bits_f[2])) | (y << L.bits_f[2]) | z;
}

// first index in [lo, hi) with keys[i] >= q (hi if none), one thread
__device__ __forceinline__ int lower_bound(const int32_t* keys, int lo, int hi, int32_t q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// A thread's queries u < PER are entries e = tid + 256 u of the tile:
// offset e / rows and row e % rows.  In down mode rows divides 256, so a
// thread keeps one row (one coarse key, loaded once) and its offsets step
// by 256 / rows.  Every global load of the block is issued before the
// first wait (the queries or coarse keys, and the probe row), and the
// PER searches of a thread run interleaved (a branchless lower bound of a
// fixed number of steps), so their shared-memory loads overlap.
template <int PER>
__global__ void __launch_bounds__(kThreads) lookup_kernel(const __grid_constant__ LookupArgs a) {
  extern __shared__ int32_t slice_s[];  // a.slice_cap rows of the table
  __shared__ int red_s[2][kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int li = 0;
  while (li + 1 < a.n_levels && (int)blockIdx.x >= a.lv[li + 1].first_block) ++li;
  const LookupLevel& L = a.lv[li];
  const int rows = a.rows, c_in = L.c_in, c_out = L.c_out, k = L.k;
  const int rel = blockIdx.x - L.first_block;
  const int cloud = rel / L.tiles;
  const int r0 = (rel % L.tiles) * rows;
  const int n_rows = min(rows, c_out - r0);
  const int32_t* kb = L.table + (size_t)cloud * c_in;
  int32_t* pb = L.pos + (size_t)cloud * k * c_out + r0;
  const int step = (c_in + kThreads - 1) / kThreads;
  const int32_t probe = __ldg(kb + min((tid + 1) * step - 1, c_in - 1));

  // 1. the thread's queries (MAXKEY past the tile), and the block's min
  // and max of the valid ones
  const bool down = a.down != 0;
  const int d_step = kThreads / rows;  // down mode: the offsets of a thread's queries
  int32_t q[PER];
  if (down) {
    const int r = tid % rows;
    const int32_t ck = r < n_rows ? __ldg(L.src + (size_t)cloud * c_out + r0 + r) : kMaxKey;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int d = tid / rows + u * d_step;
      q[u] = d < 8 ? child_key(L, ck, d) : kMaxKey;
    }
  } else {
    const int32_t* qb = L.src + (size_t)cloud * k * c_out + r0;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * kThreads, d = e / rows, r = e % rows;
      q[u] = d < k && r < n_rows ? __ldg(qb + (size_t)d * c_out + r) : kMaxKey;
    }
  }
  int qmin = kMaxKey, qmax = -kMaxKey - 1;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    if (q[u] != kMaxKey) {
      qmin = min(qmin, q[u]);
      qmax = max(qmax, q[u]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }
  if (lane == 0) {
    red_s[0][warp] = qmin;
    red_s[1][warp] = qmax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    qmin = min(qmin, red_s[0][w]);
    qmax = max(qmax, red_s[1][w]);
  }

  // 2. pa probes below the min: lower_bound(min) >= pa * step; pb_ below
  // the max: lower_bound(max) <= row (pb_ + 1) * step - 1 (C_in when 256)
  int lo = 0, hi = 0;
  if (qmin != kMaxKey) {  // uniform over the block
    const int pa = __syncthreads_count(probe < qmin);
    const int pb_ = __syncthreads_count(probe < qmax);
    lo = min(pa * step, c_in);
    hi = pb_ < kThreads ? min((pb_ + 1) * step, c_in) : c_in;  // exclusive
  }
  const int n_slice = hi - lo;  // >= 0
  int pos[PER];
  if (n_slice <= a.slice_cap) {
    // 3. the run in shared memory; a branchless lower bound over it
    for (int e = tid; e < n_slice; e += kThreads) cp_async4(slice_s + e, kb + lo + e);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    int base[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) base[u] = 0;
    for (int n = n_slice; n > 1; n -= n >> 1) {
      const int half = n >> 1;
#pragma unroll
      for (int u = 0; u < PER; ++u)
        base[u] = slice_s[base[u] + half] < q[u] ? base[u] + half : base[u];
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = base[u] + (n_slice > 0 && slice_s[base[u]] < q[u]);
      pos[u] = q[u] != kMaxKey && i < n_slice && slice_s[i] == q[u] ? lo + i : c_in;
    }
  } else {
    // 4. the run does not fit: each query searches the global table
    if (tid == 0 && a.overflow) atomicAdd(a.overflow, 1);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = q[u] != kMaxKey ? lower_bound(kb, lo, hi, q[u]) : hi;
      pos[u] = i < hi && __ldg(kb + i) == q[u] ? i : c_in;
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * kThreads;
    const int d = down ? tid / rows + u * d_step : e / rows, r = down ? tid % rows : e % rows;
    if (d < k && r < n_rows) pb[(size_t)d * c_out + r] = pos[u];
  }
}

template <int PER>
int launch(const LookupArgs& a, unsigned blocks, void* stream) {
  const size_t smem = sizeof(int32_t) * (size_t)a.slice_cap;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lookup_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lookup_kernel<PER><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace egonn

// n_levels levels, each a table (batch, c_in[i]) of sorted keys, a query
// source srcs[i] ((batch, k[i], c_out[i]) queries, or with down != 0 the
// coarse keys (batch, c_out[i]) and k[i] = 8) and an output pos[i]
// (batch, k[i], c_out[i]); packs[12 i ...]: the coarse level's bits and
// offsets, then the fine level's (down mode).  One block per (level, cloud,
// tile of `rows` output rows), 1 <= rows <= 256; runs of more than
// slice_cap table rows search the global table and are added to *overflow
// (or not counted, if null).
extern "C" int egonn_lookup(const int32_t* const* tables, const int32_t* const* srcs,
                            int32_t* const* pos, const int* c_in, const int* c_out, const int* k,
                            const int* packs, int n_levels, int batch, int rows, int slice_cap,
                            int down, int* overflow, void* stream) {
  using namespace egonn;
  if (n_levels < 1 || n_levels > kMaxLevels || rows < 1 || rows > kThreads || slice_cap < 1 ||
      slice_cap > kMaxSlice)
    return (int)cudaErrorInvalidValue;
  LookupArgs a = {};
  a.n_levels = n_levels;
  a.rows = rows;
  a.slice_cap = slice_cap;
  a.down = down;
  a.overflow = overflow;
  long long blocks = 0;
  for (int i = 0; i < n_levels; ++i) {
    if (c_in[i] < 1 || c_out[i] < 1 || k[i] < 1 || k[i] * rows > kThreads * kMaxPer ||
        (down && (k[i] != 8 || kThreads % rows)))
      return (int)cudaErrorInvalidValue;
    LookupLevel& L = a.lv[i];
    L.table = tables[i];
    L.src = srcs[i];
    L.pos = pos[i];
    L.c_in = c_in[i];
    L.c_out = c_out[i];
    L.k = k[i];
    L.tiles = (c_out[i] + rows - 1) / rows;
    L.first_block = (int)blocks;
    for (int j = 0; j < 3; ++j) {
      L.bits_c[j] = packs[12 * i + j];
      L.off_c[j] = packs[12 * i + 3 + j];
      L.bits_f[j] = packs[12 * i + 6 + j];
      L.off_f[j] = packs[12 * i + 9 + j];
    }
    blocks += (long long)batch * L.tiles;
  }
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int k_max = 0;
  for (int i = 0; i < n_levels; ++i) k_max = max(k_max, k[i]);
  const int per = (k_max * rows + kThreads - 1) / kThreads;  // queries per thread
  const unsigned grid = (unsigned)blocks;
  if (per <= 1) return launch<1>(a, grid, stream);
  if (per <= 2) return launch<2>(a, grid, stream);
  if (per <= 4) return launch<4>(a, grid, stream);
  return launch<8>(a, grid, stream);
}
