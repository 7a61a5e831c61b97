// The transposed k=2 s=2 convolution, from a coarse level onto the finer
// level's coordinates (the FPN heads' and MinkFPN's top-down step, and the
// down conv's dX in training):
//
//   out[b, i, :] = feats[b, up_parent[b, i], :] @ w[up_koffset[b, i]]
//
// and zero where fine row i has no parent (up_parent the sentinel c_coarse,
// padding rows included).
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA
// (egonn_tpu/sparse/conv.py::sparse_tconv2x2).  Its torch form on the card
// gathered every fine row's parent, multiplied it by all 8 slots' kernels in
// one f32 cuBLAS GEMM (a (B, C, 8 x F_out) temporary, 5.4 GB at MinkLoc3D's
// 64 clouds x 10,240 rows x 256 wide) and kept the one slot the row is in:
// 8 times the useful products, on the non-tensor-core f32 path.
//
// Design.  Each valid fine row has exactly one slot.  The wrapper hands in
// a slot order of each cloud's rows (`kernels.slot_order`, built once per
// level of a pyramid): the rows of slot 0 in ascending order, then slot 1's,
// ..., slot 7's, then the rows without a parent, with the 10 segment bounds
// per cloud.  A block owns (NS-column slice of F_out, 128-row tile of one
// segment, cloud): the tile's rows all take the same w[slot], so the block
// is a dense 128 x NS x F_in product whose A rows are gathered.
// - Blocks are launched at capacity (ceil(C_fine / 128) + 8 tiles a cloud,
//   the most that 9 segments can cut C_fine into); each finds its segment
//   from the bounds, and blocks past the cloud's last tile exit at once, so
//   the host never reads a size.
// - The tile's fine rows and their parents are read once into shared
//   memory.  F_in is walked in 32-column stages through a ring of three
//   shared-memory buffers (two stages in flight): each stage gathers the
//   tile's parent rows' 32 columns with cp.async (16 bytes a copy; rows past
//   the tile's end and columns past F_in zero-filled by src-size 0) beside
//   w[slot]'s 32 rows of the block's column slice.  A tile's parents lie in
//   a short run of the coarse table (the fine table is key-sorted and a
//   parent's key is its child's halved), and the column slices of a tile
//   are neighbours in the grid, so the gathers hit L2.  Rows are padded (A
//   by 4 floats, w by 8) so that the fragment loads hit 32 distinct banks.
// - Warp (wr, wc) of 4 x 2 owns rows 32 wr .. 32 wr + 31 and the columns
//   wc * NS / 2 .. of the slice, as 2 x NS / 16 mma.sync m16n8k8 tiles
//   multiplied in split TF32 (tf32x3.cuh: f32 accuracy), each operand split
//   once as it leaves shared memory.  (w split once a call by a launch of
//   its own, its halves staged as they are, took 1.84 against 1.95 ms of a
//   MinkLoc3D b64 forward on an H100, at 128 registers with a spill: not
//   kept.)  A stage's products go to fresh accumulators (the tensor cores'
//   accumulation truncates: kept to one stage's 12 MMA steps) and are added
//   in f32 to the warp's running sums in registers; warps whose rows lie
//   past the tile's end skip the MMAs.
// - The running sums are staged through shared memory and each row is
//   stored once, NS contiguous floats at its own position: no atomics and a
//   fixed summation order, so equal inputs give bit-equal outputs.  Tiles
//   of the segment without a parent store zeros.
//
// Bound: f32 work at three TF32 MMAs a product, 495 / 3 = 165 TFLOP/s,
// against the bytes of feats, the up map, w and out.  At 256 x 256 wide the
// operations bound it (2 x rows x 256 x 256 against each row's 1 KB out);
// at 32 wide the bytes do.
//
// Shapes: F_in a multiple of 4, F_out a multiple of the slice `cols` (32
// or 64); the entry point returns cudaErrorInvalidValue otherwise.
//
// The slot order (slot_order_kernel, `kernels.slot_order`): a stable
// counting sort of each cloud's rows by key (the slot, 8 for no parent), one
// block per cloud.  A first pass counts each key's rows (each warp's lanes
// of one key matched with __match_any_sync, their count added by one lane to
// a shared counter: integer adds, so the counts do not depend on their
// order), which give the segment bounds; a second pass walks the rows in
// chunks of the block's width, in order, and places each row at its key's
// next free position plus the rows of its key before it in the chunk (the
// lanes below it in its warp, then the warps below its own), so each
// segment keeps the rows' order.  Bound: bytes (the up map read twice, the
// order written once); replaces a torch sort of the keys and its bounds
// (~8 launches, 0.2-0.3 ms at the cells' shapes on an H100).
#include "tf32x3.cuh"

namespace egonn {

constexpr int kTcRows = 128;            // rows of a tile
constexpr int kTcThreads = 256;         // 8 warps: 4 along the rows x 2 along the columns
constexpr int kTcChunk = 32;            // F_in columns a stage
constexpr int kTcLdA = kTcChunk + 4;    // shared row stride of the gathered rows (floats)
constexpr int kTcStages = 3;            // ring depth: two stages in flight
constexpr int kTcSegs = 9;              // slots 0..7, then the rows without a parent

template <int NS>
__host__ __device__ constexpr int tc_stage_floats() {
  return kTcRows * kTcLdA + kTcChunk * (NS + 8);
}
template <int NS>
__host__ __device__ constexpr int tc_smem_bytes() {  // the ring + the tile's rows and parents
  return 4 * kTcStages * tc_stage_floats<NS>() + 2 * 4 * kTcRows;
}

template <int NS>
__global__ void __launch_bounds__(kTcThreads, 2)
tconv_kernel(const float* __restrict__ feats, const int32_t* __restrict__ up_parent,
             const int32_t* __restrict__ order, const int32_t* __restrict__ seg,
             const float* __restrict__ w, float* __restrict__ out, int c_coarse, int c_fine,
             int f_in, int f_out) {
  constexpr int kLdB = NS + 8;     // shared row stride of the w slice
  constexpr int kLdC = NS + 8;     // shared row stride of the output tile
  constexpr int kStage = tc_stage_floats<NS>();
  constexpr int NT = NS / 16;      // 8-column MMA tiles of a warp's NS / 2 columns
  static_assert(kTcRows * kLdC <= kTcStages * kStage, "the output tile reuses the ring");

  extern __shared__ float4 tc_smem4[];
  float* stage_s = reinterpret_cast<float*>(tc_smem4);                 // kTcStages x kStage
  int* row_s = reinterpret_cast<int*>(stage_s + kTcStages * kStage);   // the tile's fine rows
  int* par_s = row_s + kTcRows;                                        // their parents

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const int b = blockIdx.z, col0 = blockIdx.x * NS;

  // this block's tile: tile blockIdx.y of the cloud's segments, each cut
  // into 128-row tiles in order
  const int32_t* seg_b = seg + (size_t)b * (kTcSegs + 1);
  int s = 0, start = 0, n = 0, tile = blockIdx.y;
  for (; s < kTcSegs; ++s) {
    const int lo = seg_b[s], hi = seg_b[s + 1];
    const int tiles = (hi - lo + kTcRows - 1) / kTcRows;
    if (tile < tiles) {
      start = lo + tile * kTcRows;
      n = min(kTcRows, hi - start);
      break;
    }
    tile -= tiles;
  }
  if (s == kTcSegs) return;  // past the cloud's last tile

  const int32_t* order_b = order + (size_t)b * c_fine;
  for (int j = tid; j < kTcRows; j += kTcThreads) {
    const int r = j < n ? order_b[start + j] : 0;
    row_s[j] = r;
    par_s[j] = j < n && s < 8 ? up_parent[(size_t)b * c_fine + r] : 0;
  }
  __syncthreads();
  float* out_b = out + (size_t)b * c_fine * f_out + col0;
  if (s == 8) {  // rows without a parent
    for (int e = tid; e < n * (NS / 4); e += kTcThreads) {
      const int j = e / (NS / 4), q = e % (NS / 4);
      *reinterpret_cast<float4*>(out_b + (size_t)row_s[j] * f_out + 4 * q) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  const float* feats_b = feats + (size_t)b * c_coarse * f_in;
  const float* w_s = w + (size_t)s * f_in * f_out + col0;
  const int n_chunks = (f_in + kTcChunk - 1) / kTcChunk;
  const int n32 = (n + 31) & ~31;  // rows the active warps read

  // stage c -> buffer `buf`: the parents' columns c0 .. c0 + 31 in rows
  // 0 .. n32 - 1 (zeros past n and past F_in), and w[slot]'s rows c0 ..
  // c0 + 31 of the column slice (zeros past F_in)
  auto load_stage = [&](int c, int buf) {
    float* a_s = stage_s + buf * kStage;
    float* b_s = a_s + kTcRows * kTcLdA;
    const int c0 = c * kTcChunk;
    const int kc = min(kTcChunk, f_in - c0);  // valid columns (a multiple of 4)
    for (int e = tid; e < n32 * (kTcChunk / 4); e += kTcThreads) {
      const int j = e >> 3, q = e & 7;
      const bool ok = j < n && 4 * q < kc;
      cp_async16(a_s + j * kTcLdA + 4 * q,
                 ok ? feats_b + (size_t)par_s[j] * f_in + c0 + 4 * q : feats, ok ? 16 : 0);
    }
    for (int e = tid; e < kTcChunk * (NS / 4); e += kTcThreads) {
      const int rr = e / (NS / 4), q = e % (NS / 4);
      const bool ok = rr < kc;
      cp_async16(b_s + rr * kLdB + 4 * q, ok ? w_s + (size_t)(c0 + rr) * f_out + 4 * q : w,
                 ok ? 16 : 0);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const bool active = wr * 32 < n;

  // warp (wr, wc): its 32 rows x NS / 2 columns of the stage, three split
  // products into fresh accumulators, then added to the running sums
  auto compute_stage = [&](int c, int buf) {
    const float* a_s = stage_s + buf * kStage + wr * 32 * kTcLdA;
    const float* b_s = stage_s + buf * kStage + kTcRows * kTcLdA + wc * (NS / 2);
    const int kcp = (min(kTcChunk, f_in - c * kTcChunk) + 7) & ~7;  // padded to the MMA depth
    float part[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kcp; kk += 8) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = a_s + (mt * 16 + g) * kTcLdA + kk + t;
        split_tf32(p[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(p[8 * kTcLdA], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(p[4], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(p[8 * kTcLdA + 4], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b_hi[2], b_lo[2];
        const float* q = b_s + (kk + t) * kLdB + nt * 8 + g;
        split_tf32(q[0], b_hi[0], b_lo[0]);
        split_tf32(q[4 * kLdB], b_hi[1], b_lo[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_3xtf32(part[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  };

  // the stages through the ring, kTcStages - 1 in flight: stage c +
  // kTcStages - 1 is loaded into the buffer that stage c - 1 left
  for (int c = 0; c < kTcStages - 1; ++c) {
    if (c < n_chunks) load_stage(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kTcStages - 2>();  // stage c has landed
    __syncthreads();                 // ... for every thread; stage c - 1 is done
    if (c + kTcStages - 1 < n_chunks)
      load_stage(c + kTcStages - 1, (c + kTcStages - 1) % kTcStages);
    cp_async_commit();
    if (active) compute_stage(c, c % kTcStages);
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage is done with the ring

  // the running sums through shared memory, then each row's NS columns
  // stored once, 16 bytes a thread
  float* c_s = stage_s;
  if (active) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = wr * 32 + mt * 16 + g, col = wc * (NS / 2) + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(c_s + r * kLdC + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(c_s + (r + 8) * kLdC + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
  __syncthreads();
  for (int e = tid; e < n * (NS / 4); e += kTcThreads) {
    const int j = e / (NS / 4), q = e % (NS / 4);
    *reinterpret_cast<float4*>(out_b + (size_t)row_s[j] * f_out + 4 * q) =
        *reinterpret_cast<const float4*>(c_s + j * kLdC + 4 * q);
  }
}

template <int NS>
int launch_tconv_ns(const float* feats, const int32_t* up_parent, const int32_t* order,
                    const int32_t* seg, const float* w, float* out, int batch, int c_coarse,
                    int c_fine, int f_in, int f_out, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<NS>();
  const cudaError_t err = cudaFuncSetAttribute(
      tconv_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(f_out / NS, (c_fine + kTcRows - 1) / kTcRows + kTcSegs - 1, batch);
  tconv_kernel<NS><<<grid, kTcThreads, smem, st>>>(feats, up_parent, order, seg, w, out,
                                                    c_coarse, c_fine, f_in, f_out);
  return (int)cudaGetLastError();
}

int launch_tconv(const float* feats, const int32_t* up_parent, const int32_t* order,
                 const int32_t* seg, const float* w, float* out, int batch, int c_coarse,
                 int c_fine, int f_in, int f_out, int cols, cudaStream_t st) {
  if ((cols != 32 && cols != 64) || f_out <= 0 || f_out % cols || f_in <= 0 || f_in % 4 ||
      batch < 0 || c_fine < 0 || c_coarse < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || c_fine == 0) return (int)cudaSuccess;
  return cols == 64 ? launch_tconv_ns<64>(feats, up_parent, order, seg, w, out, batch, c_coarse,
                                          c_fine, f_in, f_out, st)
                    : launch_tconv_ns<32>(feats, up_parent, order, seg, w, out, batch, c_coarse,
                                          c_fine, f_in, f_out, st);
}

constexpr int kSoThreads = 1024;  // rows of a chunk of slot_order_kernel's second pass

__global__ void __launch_bounds__(kSoThreads)
slot_order_kernel(const int32_t* __restrict__ up_parent, const int32_t* __restrict__ up_koffset,
                  int32_t* __restrict__ order, int32_t* __restrict__ seg, int c_coarse,
                  int c_fine) {
  __shared__ int count_s[kTcSegs];                  // each key's rows
  __shared__ int base_s[kTcSegs];                   // each key's next free position
  __shared__ int warp_s[kSoThreads / 32][kTcSegs];  // a chunk's rows per (warp, key), then offsets
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.x;
  const int32_t* par_b = up_parent + (size_t)b * c_fine;
  const int32_t* ko_b = up_koffset + (size_t)b * c_fine;
  // the key of row i: its slot, kTcSegs - 1 without a parent; rows past the
  // cloud's end take kTcSegs, which nothing counts
  auto key_of = [&](int i) {
    if (i >= c_fine) return kTcSegs;
    const int p = par_b[i], k = ko_b[i];
    return p >= 0 && p < c_coarse && k >= 0 && k < 8 ? k : kTcSegs - 1;
  };
  const unsigned below = (1u << lane) - 1;

  if (tid < kTcSegs) count_s[tid] = 0;
  __syncthreads();
  // 1. each key's rows
  for (int base = 0; base < c_fine; base += kSoThreads) {
    const int key = key_of(base + tid);
    const unsigned m = __match_any_sync(0xffffffffu, key);
    if (key < kTcSegs && (m & below) == 0) atomicAdd(&count_s[key], __popc(m));
  }
  __syncthreads();
  // 2. the segment bounds
  if (tid == 0) {
    int at = 0;
    for (int k = 0; k < kTcSegs; ++k) {
      base_s[k] = at;
      seg[(size_t)b * (kTcSegs + 1) + k] = at;
      at += count_s[k];
    }
    seg[(size_t)b * (kTcSegs + 1) + kTcSegs] = at;
  }
  // 3. the rows in chunks, in order: a row's position is its key's next free
  // one, plus the chunk's rows of its key in the warps below and the lanes
  // below it
  for (int base = 0; base < c_fine; base += kSoThreads) {
    for (int e = tid; e < (kSoThreads / 32) * kTcSegs; e += kSoThreads) (&warp_s[0][0])[e] = 0;
    __syncthreads();  // the last chunk is placed; base_s is current
    const int key = key_of(base + tid);
    const unsigned m = __match_any_sync(0xffffffffu, key);
    if (key < kTcSegs && (m & below) == 0) warp_s[warp][key] = __popc(m);
    __syncthreads();
    if (tid < kTcSegs) {
      int at = base_s[tid];
      for (int w = 0; w < kSoThreads / 32; ++w) {
        const int c = warp_s[w][tid];
        warp_s[w][tid] = at;
        at += c;
      }
      base_s[tid] = at;
    }
    __syncthreads();
    if (key < kTcSegs)
      order[(size_t)b * c_fine + warp_s[warp][key] + __popc(m & below)] = base + tid;
    __syncthreads();  // every row of the chunk has read warp_s
  }
}

int launch_slot_order(const int32_t* up_parent, const int32_t* up_koffset, int32_t* order,
                      int32_t* seg, int batch, int c_coarse, int c_fine, cudaStream_t st) {
  if (batch < 0 || c_fine < 0 || c_coarse < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  slot_order_kernel<<<batch, kSoThreads, 0, st>>>(up_parent, up_koffset, order, seg, c_coarse,
                                                  c_fine);
  return (int)cudaGetLastError();
}

}  // namespace egonn

// up_parent, up_koffset and order (batch, c_fine), seg (batch, 10) int32,
// contiguous.  Returns cudaGetLastError().
extern "C" int egonn_slot_order(const int32_t* up_parent, const int32_t* up_koffset,
                                int32_t* order, int32_t* seg, int batch, int c_coarse,
                                int c_fine, void* stream) {
  return egonn::launch_slot_order(up_parent, up_koffset, order, seg, batch, c_coarse, c_fine,
                                  static_cast<cudaStream_t>(stream));
}

// feats (batch, c_coarse, f_in), w (8, f_in, f_out) and out (batch, c_fine,
// f_out) f32; up_parent and order (batch, c_fine), seg (batch, 10) int32
// (`kernels.slot_order`); all contiguous and 16-byte aligned.  Returns
// cudaGetLastError() (or the first error).
extern "C" int egonn_tconv(const float* feats, const int32_t* up_parent, const int32_t* order,
                           const int32_t* seg, const float* w, float* out, int batch,
                           int c_coarse, int c_fine, int f_in, int f_out, int cols,
                           void* stream) {
  return egonn::launch_tconv(feats, up_parent, order, seg, w, out, batch, c_coarse, c_fine, f_in,
                             f_out, cols, static_cast<cudaStream_t>(stream));
}
