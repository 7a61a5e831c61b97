// Building blocks shared by the tensor-core kernels (gather_mm.cuh, tdown.cu,
// gather_dw.cu): 16-byte cp.async copies into shared memory, and a f32
// product on the tensor cores in split TF32 ("3xTF32").
//
// Split TF32: each f32 operand x is split once, in registers, into
// hi = tf32_rna(x) and lo = tf32_rna(x - hi).  x - hi is exact in f32 and
// holds at most 13 significant bits, so |x - hi - lo| <= 2^-22 |x|.  A product
// a*b is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b: each of the three
// products is exact in f32 (11 x 11 significant bits), and the dropped
// lo_a*lo_b and split residuals are <= ~2^-21 |a b|, below f32's own rounding
// of a long sum.  The small terms are summed first.  The tensor cores' f32
// accumulation is not IEEE round-to-nearest (it truncates): measured on an
// H100, 1,300 chained MMA steps (K = 27 x 128 channels x 3) into one
// accumulator lost ~1.3e-5 of the result's scale.  So the callers keep at
// most one 64-deep stage (24 steps) in fresh accumulators and add that to
// the running sum with an f32 add.  One TF32 multiply alone keeps 11 bits
// (relative error 2^-11 per product): at K = 27 and 128 channels that misses
// the f32 tolerances by two orders of magnitude.  tests/test_torch_kernels.py
// emulates each of these in numpy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace egonn {

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes 16 zero bytes
// (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c (16x8) += a (16x8, row) * b (8x8, col) on the tensor cores.  Per lane
// (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[0] += hi*hi, c[1] += lo*hi, c[2] += hi*lo: the three products of a * b
// in split TF32, each into its own accumulator, so that they do not wait
// for one another (a dependent mma.sync waits out the one before); the
// caller adds c[0] + (c[1] + c[2]), the small terms first.  gather_mm.cuh
// and tdown.cu use it: a warp there holds few accumulators.
__device__ __forceinline__ void mma_3xtf32_sets(float (&c)[3][4], const uint32_t (&a_hi)[4],
                                                const uint32_t (&a_lo)[4],
                                                const uint32_t (&b_hi)[2],
                                                const uint32_t (&b_lo)[2]) {
  mma_tf32(c[1], a_lo, b_hi);
  mma_tf32(c[2], a_hi, b_lo);
  mma_tf32(c[0], a_hi, b_hi);
}

// c += a * b in split TF32: lo*hi + hi*lo first, then hi*hi, in one
// accumulator.  gather_dw.cu uses it: a warp there has up to 8 independent
// 16 x 8 tiles in flight, and three accumulators each made it slower on an
// H100 at 700 W (the train step's 45 calls 6.26 -> 6.68 ms, chip_smoke.py).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

}  // namespace egonn
