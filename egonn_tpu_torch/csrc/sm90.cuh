// Hopper (sm_90a) building blocks of the bf16 gather conv and dW bodies
// (gather_mm_sm90.cuh, gather_dw.cu): mbarriers, the asynchronous copies that
// complete on them (cp.async, TMA), wgmma and its shared-memory descriptors,
// and the host-side encoding of a TMA tensor map.
//
// Shared-memory tiles that wgmma reads use the 128-byte swizzle: a tile row
// of 128 bytes (64 bf16) holds its 16-byte pieces q at q ^ (row mod 8), the
// rows 128 bytes apart, tiles 1024-byte aligned (the swizzle works on address
// bits 4-9).  A TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes that layout;
// `swz128` gives the place of a piece that a cp.async writes.  In a K-major
// operand (W^T's rows, 64 deep) a tile row is one row of the operand and a
// 16-deep step starts 32 bytes further; in an MN-major one (gathered rows in
// the dW body, contracted over) a tile row is one depth of 64 rows or
// columns and a 16-deep step starts 16 rows (2048 bytes) further.  Either
// way the 8-row groups are 1024 bytes apart (the descriptor's stride byte
// offset).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_runtime.h>
#include <stdint.h>

namespace egonn {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte piece q of row `row` in a 128-byte-swizzled tile
__host__ __device__ __forceinline__ uint32_t swz128(int row, int q) {
  return (uint32_t)row * 128u + (uint32_t)((q ^ (row & 7)) << 4);
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the block's threads and to the
// asynchronous proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival, and `bytes` more to come from TMA copies completing on bar
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits until the barrier's phase of this parity has completed (acquire).  A
// wait that lasts ~10 s of SM clock traps: a wrong parity or a missing
// arrival then ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  if (mbar_try_wait(b, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(b, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// --- asynchronous copies ----------------------------------------------------

// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// an arrival on bar once every earlier cp.async of this thread has landed;
// `noinc`: the barrier's count includes it
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// a box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory, its bytes completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// orders this thread's view of shared memory (what it read or acquired) with
// its later asynchronous-proxy accesses (wgmma operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = (scale_d ? d : 0) + a (64 x 16) * b (16 x N), N = 32 or
// 64: a from registers (each warp's 16 rows as an mma.m16n8k16 A
// fragment), b in shared memory, K-major, by descriptor; bf16 operands
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) = (scale_d ? d : 0) + a (64 x 16) * b (16 x 64), both in
// shared memory and MN-major (a's 64 rows and b's 64 columns contiguous, the
// 16 deep strided), by descriptors; bf16 operands
__device__ __forceinline__ void wgmma_m64n64k16_ss_mn(float (&d)[32], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Four 8x8 matrices of 16-bit elements from shared memory (lanes 8q .. 8q+7
// give the row addresses of matrix q; lane (g = lane / 4, t = lane % 4)
// receives elements (g, 2t) and (g, 2t + 1) of matrix q in register q)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

}  // namespace sm90

// --- host: TMA tensor maps ----------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
using TensorMapEncoder = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                      const cuuint32_t*, CUtensorMapInterleave,
                                      CUtensorMapSwizzle, CUtensorMapL2promotion,
                                      CUtensorMapFloatOOBfill);

inline TensorMapEncoder tensor_map_encoder() {
  static TensorMapEncoder fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<TensorMapEncoder>(p);
  }
  return fn;
}

// A 3-D bf16 tensor (d0 innermost, contiguous) read in boxes of b0 x b1 x 1
// with the 128-byte swizzle (b0 * 2 <= 128); elements past the tensor's end
// read as zero.  False if the encoder is missing or refuses.
inline bool bf16_tensor_map_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                               uint64_t d2, uint32_t b0, uint32_t b1) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace egonn
