// The Hopper body of the bf16 gather conv (egonn_gather_conv_bf16; the
// function, maps and epilogue of gather_mm.cuh):
//
//   out[b, r, :] = epi( sum_k feats[b, kmap[b, k, r], :] @ w[k] ),  bf16 rows and W,
//   exact products summed in f32, the epilogue in f32, one rounding at the store.
//
// Replaces egonn_tpu/sparse/banded.py _pallas_banded_conv on bf16 operands
// (:410), as gather_mm_bf16_kernel (the SM80 body, gather_mm.cuh) does; the
// launch rule (sparse/kernels.py `conv_body`) picks one of the two per call.
//
// What held the SM80 body back: a block-wide barrier and a round trip to L2
// for every (offset, 64-column) stage of 14-30% valid rows, the products in
// 16-row mma.sync tiles, each stage's result scattered into a shared f32
// tile.  This body:
// - Block: two (NS = 32, two blocks an SM) or four (NS = 64, one block an
//   SM) producer warps and two consumer warpgroups, per (NS = 32 or 64
//   output columns, tile of 128 output rows, cloud, offset group), the grid
//   of gather_mm_bf16_kernel.  All warps first load the tile's kmap entries
//   of a group of <= 32 offsets and compact each offset's valid (row, source)
//   pairs in row order, with each row's place in its offset's list (the
//   compaction of gather_mm.cuh, plus the places).
// - Stages filled with valid rows: a stage holds up to 64 gathered rows,
//   packed from the group's active offsets in ascending order (runs: an
//   offset's next <= 64 valid rows, an offset's list running on into the
//   next stage where it does not fit), times one 64-column F_in chunk.  At
//   14% valid entries a stage carries ~3-4 offsets, on the sparse deep
//   levels tens.  Two rings, each signalled by mbarriers (full: landed;
//   empty: the 8 consumer warps are done with it): 4 stages of rows, and as
//   many W^T tiles (one NS x 64 tile a run) as the rest of the SM's shared
//   memory holds (SmConvLayout; a stage holds at most that many runs).  No
//   block-wide barrier inside a group.
// - The producer warps, for each stage: wait for an empty row buffer; for
//   each run the first waits for an empty W^T buffer and loads W^T[k]'s
//   tile with TMA (128-byte swizzle, columns past F_in zero), and all gather
//   the run's rows with 16-byte cp.async pieces (a row's pieces on
//   neighbouring lanes); then each producer lane arrives on the stage's full
//   barrier once its copies have landed (cp.async.mbarrier.arrive.noinc), so
//   no stage waits for a later one to be issued.  A stage holds at most as
//   many runs as the W^T ring has buffers: the producers never wait for a
//   buffer that only their own unfinished stage would free.
// - Multiply: warpgroup g owns the tile's output rows 64g .. 64g + 63 as the
//   M = 64 rows of wgmma m64nNSk16, its f32 accumulator in registers for the
//   whole tile: no compaction into MMA tiles, no scatter, no shared
//   accumulator.  For each run, each warp reads its 16 rows' fragments with
//   ldmatrix from the rows' places in the stage (a row without a pair in the
//   run reads any row and is masked to zero in the registers, as are
//   columns past F_in), and the run's W^T tile is wgmma's B operand in
//   shared memory (K-major, descriptor).  A warpgroup none of whose rows is
//   in the run skips its multiply.  Each run's product goes to fresh
//   accumulators that are added to the running sum in f32 (the tensor cores'
//   own accumulation truncates), in a fixed order.
// - The epilogue is applied in registers at the single store.  Offset groups
//   (n_groups > 1) write raw f32 sums to `partial` for gather_mm_sum_kernel,
//   as gather_mm_bf16_kernel does.  No atomics: repeats are bit-equal.
//
// Bound: the bytes of feats, kmap, W and out.  Where it wins over the SM80
// body, and why, is in PERF.md (probe_kernels.py bf16 and its cut-outs);
// `conv_body` follows it.
#pragma once

#include "bf16.cuh"
#include "sm90.cuh"

namespace egonn {

constexpr int kSmRows = 128;          // output rows of a block: two warpgroups of 64
constexpr int kSmConsumerWarps = 8;
constexpr int kSmSeg = 64;            // gathered rows a stage holds
constexpr int kSmGroup = 32;          // offsets whose maps are held at once
constexpr int kSmRowStages = 4;       // the ring of gathered rows

// The NS-column body's rings and shared memory, in bytes from a 1024-byte
// aligned base.  A stage holds 64 F_in columns of its rows (128 bytes a row,
// 128-byte swizzled), as does a W^T tile (NS rows).  NS = 32 runs two blocks
// an SM, NS = 64 one (its accumulators and a stage's fragments need more
// registers; NS = 128 spilled); the W^T ring is as deep as the rest of the
// SM's shared memory allows, up to 32.
template <int NS>
struct SmConvLayout {
  static constexpr int kBlocksPerSm = NS == 32 ? 2 : 1;
  // producer warps: two in each of two blocks, or four in one, issue an
  // SM's row gathers (one warp alone issued them 8-23% slower on an H100)
  static constexpr int kProducers = NS == 32 ? 2 : 4;
  static constexpr int kThreads = 32 * (kSmConsumerWarps + kProducers);
  static constexpr int kW = NS * 128;         // W^T[k]'s NS x 64 tile
  static constexpr int kRows = kSmSeg * 128;  // a stage's rows, 64 columns each
  // the lists, places, counts, mbarriers (at most 2 x (4 + 32)) and slack
  static constexpr int kFixed = kSmGroup * kSmRows * 5 + kSmGroup * 8 + 2 * 36 * 8 + 1024;
  static constexpr int kFree = 233472 / kBlocksPerSm - 1024 - kFixed - kSmRowStages * kRows;
  static constexpr int kWSlots = kFree / kW < 32 ? kFree / kW : 32;
  static constexpr int rows_off = kWSlots * kW;
  static constexpr int pair_off = rows_off + kSmRowStages * kRows;  // kSmGroup x 128 ints
  static constexpr int pos_off = pair_off + kSmGroup * kSmRows * 4;  // kSmGroup x 128 bytes
  static constexpr int cnt_off = pos_off + kSmGroup * kSmRows;       // kSmGroup ints
  static constexpr int lo_off = cnt_off + kSmGroup * 4;              // kSmGroup ints
  static constexpr int bar_off = lo_off + kSmGroup * 4;  // full and empty, rows then W^T
  static constexpr int bytes = bar_off + 2 * (kSmRowStages + kWSlots) * 8 + 1024;
  static_assert(kWSlots >= 6 && bytes <= 232448, "the rings do not fit");
};

// a value the compiler may treat as uniform across the warp (lane 0's): the
// wgmma calls behind branches on it are not serialized
__device__ __forceinline__ int warp_uniform(int v) { return __shfl_sync(0xffffffffu, v, 0); }

template <int NS>
__device__ __forceinline__ void wgmma_rs(float (&d)[NS / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (NS == 32)
    sm90::wgmma_m64n32k16_rs(d, a, desc_b, scale_d);
  else
    sm90::wgmma_m64n64k16_rs(d, a, desc_b, scale_d);
}

// The first offset of a group of kg offsets with cnt valid rows each, at or
// after kl, that has a valid row (kg if none)
__device__ __forceinline__ int next_active(const int* cnt_s, int kg, int kl) {
  while (kl < kg && warp_uniform(cnt_s[kl]) == 0) ++kl;
  return kl;
}

// The runs of the stage that starts at (offset kl, list place seg0):
// f(kl, seg0, n, place) for each run of n rows (the offset's list places
// seg0 .. seg0 + n - 1 at the stage's rows place ..), in order, at most
// max_runs of them; returns the next stage's start.  Every warp walks the
// same stages.
template <class F>
__device__ __forceinline__ int2 walk_stage(const int* cnt_s, int kg, int kl, int seg0,
                                           int max_runs, F&& f) {
  for (int place = 0, runs = 0; kl < kg && place < kSmSeg && runs < max_runs; ++runs) {
    const int cnt = warp_uniform(cnt_s[kl]);
    const int n = min(kSmSeg - place, cnt - seg0);
    f(kl, seg0, n, place);
    place += n;
    seg0 += n;
    if (seg0 == cnt) {
      kl = next_active(cnt_s, kg, kl + 1);
      seg0 = 0;
    }
  }
  return make_int2(kl, seg0);
}

template <int NS, int CUT = kCutNone>
__global__ void __launch_bounds__(SmConvLayout<NS>::kThreads, SmConvLayout<NS>::kBlocksPerSm)
gather_mm_sm90_kernel(const __grid_constant__ CUtensorMap w_map, const bf16* __restrict__ feats,
                      const int32_t* __restrict__ kmap, const float* __restrict__ scale,
                      const float* __restrict__ bias, const uint8_t* __restrict__ mask,
                      bf16* __restrict__ out, float* __restrict__ partial, int n_groups,
                      int batch, int c_in, int f_in, int k_vol, int c_out, int f_out, int relu) {
  using L = SmConvLayout<NS>;
  constexpr int SR = kSmRowStages, SW = L::kWSlots;
  constexpr int kProducerLanes = L::kThreads - 32 * kSmConsumerWarps;
  extern __shared__ uint8_t sm90_conv_raw[];
  uint8_t* smem = sm90_conv_raw + ((1024 - (sm90::smem_u32(sm90_conv_raw) & 1023)) & 1023);
  int* pair_s = reinterpret_cast<int*>(smem + L::pair_off);
  uint8_t* pos_s = smem + L::pos_off;
  int* cnt_s = reinterpret_cast<int*>(smem + L::cnt_off);
  int* lo_s = reinterpret_cast<int*>(smem + L::lo_off);
  uint64_t* full_r = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty_r = full_r + SR;
  uint64_t* full_w = empty_r + SR;
  uint64_t* empty_w = full_w + SW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * NS, row0 = blockIdx.y * kSmRows;
  const int b = blockIdx.z / n_groups, grp = blockIdx.z % n_groups;
  const int k_per = (k_vol + n_groups - 1) / n_groups;
  const int k_lo = grp * k_per, k_hi = min(k_vol, k_lo + k_per);
  const bf16* feats_b = feats + (size_t)b * c_in * f_in;
  const int32_t* kmap_b = kmap + (size_t)b * k_vol * c_out;
  const int n_chunks = (f_in + 63) / 64;  // 64-column F_in chunks

  if (tid == 0) {
    for (int s = 0; s < SR; ++s) {
      sm90::mbar_init(full_r + s, kProducerLanes);  // each producer lane, its copies landed
      sm90::mbar_init(empty_r + s, kSmConsumerWarps);
    }
    for (int s = 0; s < SW; ++s) {
      sm90::mbar_init(full_w + s, 1);  // the TMA arrival and its bytes
      sm90::mbar_init(empty_w + s, kSmConsumerWarps);
    }
    sm90::fence_mbar_init();
  }

  // consumers: this warp's 16 output rows of the tile, the row whose ldmatrix
  // address this lane gives, and its 8-column half of a 16-deep step
  const int wg = warp >> 2;
  const int rbase = wg * 64 + (warp & 3) * 16;
  const int r_addr = rbase + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  float acc[NS / 2], part[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t itr = 0, itw = 0;  // row stages and W^T tiles walked so far; all warps walk the same

  for (int k0 = k_lo; k0 < k_hi; k0 += kSmGroup) {
    const int kg = min(kSmGroup, k_hi - k0);
    __syncthreads();  // the barriers are initialised; the last group's stages are consumed
    for (int e = tid; e < kg * kSmRows; e += L::kThreads) {
      const int k = k0 + e / kSmRows, r = e % kSmRows;
      pair_s[e] = row0 + r < c_out ? kmap_b[(size_t)k * c_out + row0 + r] : c_in;
    }
    __syncthreads();
    // per offset: its valid (row, source) pairs compacted in row order in
    // place as (row << 24) | source, their count, how many lie in the first
    // 64 rows (warpgroup 0's), and each row's place in the list (0xff: none)
    for (int kl = warp; kl < kg; kl += L::kThreads / 32) {
      int* p = pair_s + kl * kSmRows;
      uint8_t* pos = pos_s + kl * kSmRows;
      int n = 0;
      for (int base = 0; base < kSmRows; base += 32) {
        const int src = p[base + lane];
        const bool v = (unsigned)src < (unsigned)c_in;
        const unsigned m = __ballot_sync(0xffffffffu, v);
        const int at = n + __popc(m & ((1u << lane) - 1));
        pos[base + lane] = v ? (uint8_t)at : (uint8_t)0xff;
        if (v) p[at] = ((base + lane) << 24) | src;
        n += __popc(m);
        if (base == 32 && lane == 0) lo_s[kl] = n;
      }
      if (lane == 0) cnt_s[kl] = n;
    }
    __syncthreads();
    if constexpr (CUT == kCutCompactOnly) continue;

    if (warp >= kSmConsumerWarps) {
      // the producers: the first producer warp loads W^T, all share the row
      // gathers
      const int pl = tid - 32 * kSmConsumerWarps;  // this lane among the producers'
      const int pw = pl >> 5;
      int2 at = make_int2(next_active(cnt_s, kg, 0), 0);
      while (at.x < kg) {
        int2 after = at;
        for (int c = 0; c < n_chunks; ++c, ++itr) {
          const uint32_t slot = itr % SR;
          sm90::mbar_wait(empty_r + slot, ((itr / SR) & 1) ^ 1);
          const int c0 = c * 64;
          const int q8 = min(64, f_in - c0) / 8;  // 16-byte pieces of a row
          // a row's pieces on neighbouring lanes (2^lg of them, the fewest
          // that cover its q8), kProducerLanes >> lg rows a copy
          const int lg = q8 <= 4 ? 2 : 3;
          const uint32_t rows_a = sm90::smem_u32(smem + L::rows_off + slot * L::kRows);
          after = walk_stage(cnt_s, kg, at.x, at.y, SW, [&](int kl, int seg0, int n, int place) {
            const uint32_t ws = itw % SW;
            if (pw == 0) sm90::mbar_wait(empty_w + ws, ((itw / SW) & 1) ^ 1);
            ++itw;
            if (pl == 0) {
              if (CUT == kCutNoWeights) {
                sm90::mbar_arrive(full_w + ws);
              } else {
                sm90::mbar_arrive_expect_tx(full_w + ws, L::kW);
                sm90::tma_load_3d(smem + ws * L::kW, &w_map, full_w + ws, c0, col0, k0 + kl);
              }
            }
            const int* pairs = pair_s + kl * kSmRows + seg0;
            if (CUT != kCutNoGather)
              for (int e = pl; e < (n << lg); e += kProducerLanes) {
                const int j = e >> lg, q = e & ((1 << lg) - 1);
                if (q < q8)
                  sm90::cp_async_16(rows_a + sm90::swz128(place + j, q),
                                    feats_b + (size_t)(pairs[j] & 0xffffff) * f_in + c0 + 8 * q,
                                    16);
              }
          });
          sm90::cp_async_arrive_noinc(full_r + slot);
        }
        at = after;
      }
      sm90::cp_async_wait<0>();
    } else {
      int2 at = make_int2(next_active(cnt_s, kg, 0), 0);
      while (at.x < kg) {
        int2 after = at;
        for (int c = 0; c < n_chunks; ++c, ++itr) {
          const uint32_t slot = itr % SR;
          sm90::mbar_wait(full_r + slot, (itr / SR) & 1);
          const int kc = warp_uniform(min(64, f_in - c * 64));  // a multiple of 8
          const uint32_t rows_a = sm90::smem_u32(smem + L::rows_off + slot * L::kRows);
          after = walk_stage(cnt_s, kg, at.x, at.y, SW, [&](int kl, int seg0, int n, int place) {
            const uint32_t ws = itw % SW;
            const uint32_t parity = (itw / SW) & 1;
            ++itw;
            // the list is in row order: warpgroup 0's rows are its first `lo`
            const int lo = warp_uniform(lo_s[kl]);
            const bool mine = warp_uniform(wg == 0 ? seg0 < lo : seg0 + n > lo);
            if (mine || CUT == kCutNoMma) sm90::mbar_wait(full_w + ws, parity);
            if (mine && CUT != kCutNoMma) {
              const int p_me = pos_s[kl * kSmRows + r_addr];
              const int j = p_me - seg0;
              const bool valid = p_me != 0xff && j >= 0 && j < n;
              // this lane's fragment rows rbase + lane / 4 (+ 8) give their
              // addresses in lanes lane / 4 (+ 8)
              const uint32_t m0 = __shfl_sync(0xffffffffu, valid, lane >> 2) ? ~0u : 0u;
              const uint32_t m1 = __shfl_sync(0xffffffffu, valid, (lane >> 2) + 8) ? ~0u : 0u;
              const int row = valid ? place + j : 0;
              const uint32_t row_a = rows_a + row * 128;
              const int rsw = row & 7;
              uint32_t a[4][4];
#pragma unroll
              for (int ks = 0; ks < 4; ++ks) {
                if (16 * ks < kc) {
                  const int q = 2 * ks + khalf;  // the row's 16-byte piece
                  sm90::ldmatrix_x4(a[ks], row_a + ((q ^ rsw) << 4));
                  const uint32_t hi = 16 * ks + 8 < kc ? ~0u : 0u;  // columns 8-15 within F_in
                  a[ks][0] &= m0;
                  a[ks][1] &= m1;
                  a[ks][2] &= m0 & hi;
                  a[ks][3] &= m1 & hi;
                }
              }
              const uint8_t* w_s = smem + ws * L::kW;
              sm90::wgmma_fence();
              sm90::fence_regs(part);
#pragma unroll
              for (int ks = 0; ks < 4; ++ks)
                if (16 * ks < kc)
                  wgmma_rs<NS>(part, a[ks], sm90::smem_desc(w_s + 32 * ks, 16, 1024), ks > 0);
              sm90::wgmma_commit();
              sm90::wgmma_wait_all();
              sm90::fence_regs(part);
#pragma unroll
              for (int i = 0; i < NS / 2; ++i) acc[i] += part[i];
            }
            __syncwarp();
            if (lane == 0) sm90::mbar_arrive(empty_w + ws);
          });
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(empty_r + slot);
        }
        at = after;
      }
    }
  }
  if (warp >= kSmConsumerWarps) return;

  // the epilogue in registers: acc[4j + 2h + e] is row rbase + lane / 4 + 8h,
  // column 8j + 2 (lane % 4) + e of the slice
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + rbase + g + 8 * h;
    if (row >= c_out) continue;
    const bool keep = !mask || mask[(size_t)b * c_out + row];
#pragma unroll
    for (int jn = 0; jn < NS / 8; ++jn) {
      const int col = col0 + 8 * jn + 2 * t;
      float v0 = acc[4 * jn + 2 * h], v1 = acc[4 * jn + 2 * h + 1];
      if (n_groups > 1) {
        *reinterpret_cast<float2*>(partial + (((size_t)grp * batch + b) * c_out + row) * f_out +
                                   col) = make_float2(v0, v1);
        continue;
      }
      if (scale) {
        v0 = v0 * scale[col] + bias[col];
        v1 = v1 * scale[col + 1] + bias[col + 1];
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (!keep) v0 = v1 = 0.f;
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * c_out + row) * f_out + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

#ifdef EGONN_PROBE_CUTS
// the cut-out `cut` (bf16.cuh) of the NS-column body, for probe_kernels.py
template <int NS>
auto gather_mm_sm90_body(int cut) {
  switch (cut) {
    case kCutNoMma: return gather_mm_sm90_kernel<NS, kCutNoMma>;
    case kCutNoGather: return gather_mm_sm90_kernel<NS, kCutNoGather>;
    case kCutCompactOnly: return gather_mm_sm90_kernel<NS, kCutCompactOnly>;
    case kCutNoWeights: return gather_mm_sm90_kernel<NS, kCutNoWeights>;
    default: return gather_mm_sm90_kernel<NS, kCutNone>;
  }
}
#else
template <int NS>
auto gather_mm_sm90_body(int) {
  return gather_mm_sm90_kernel<NS, kCutNone>;
}
#endif

// Launches gather_mm_sm90_kernel with column slices of `cols` (32 or 64)
// over W^T (k_vol, f_out, f_in) bf16 (f_in a multiple of 8), encoding
// W^T's tensor map here; n_groups as in launch_gather_mm; `cut` kCutNone,
// or (built with EGONN_PROBE_CUTS) kCutNoMma / kCutNoGather /
// kCutCompactOnly (no stages).  Returns cudaErrorNotSupported if the
// tensor map cannot be encoded.
inline int launch_gather_mm_sm90(const bf16* feats, const int32_t* kmap, const bf16* w_t,
                                 const float* scale, const float* bias, const uint8_t* mask,
                                 bf16* out, float* partial, int n_groups, int batch, int c_in,
                                 int f_in, int k_vol, int c_out, int f_out, int cols, int relu,
                                 int cut, cudaStream_t stream) {
  CUtensorMap w_map;
  if (!bf16_tensor_map_3d(&w_map, w_t, f_in, f_out, k_vol, 64, cols))
    return (int)cudaErrorNotSupported;
  const dim3 grid(f_out / cols, (c_out + kSmRows - 1) / kSmRows, batch * n_groups);
  auto kern = cols == 64 ? gather_mm_sm90_body<64>(cut) : gather_mm_sm90_body<32>(cut);
  const int smem = cols == 64 ? SmConvLayout<64>::bytes : SmConvLayout<32>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = cols == 64 ? SmConvLayout<64>::kThreads : SmConvLayout<32>::kThreads;
  kern<<<grid, threads, smem, stream>>>(w_map, feats, kmap, scale, bias, mask, out, partial,
                                           n_groups, batch, c_in, f_in, k_vol, c_out, f_out,
                                           relu);
  return (int)cudaGetLastError();
}

}  // namespace egonn
