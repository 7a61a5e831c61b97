// Building blocks of the tensor-core kernels' bf16 paths (gather_mm.cuh,
// tdown.cu), and the epilogue and stores both element types share.
//
// The bf16 paths compute what the TPU kernels compute (egonn_tpu/sparse/
// banded.py: features and weights cast to bf16, MXU products accumulated in
// f32, the epilogue in f32, the caller's cast of the f32 output to the
// activations' bf16): here the features arrive in bf16, the wrapper rounds
// the weights to bf16 (and transposes them, so that a B fragment's two
// neighbouring depths are one 32-bit load), and mma.sync m16n8k16 multiplies
// them into f32 accumulators.  The product of two bf16 values is exact in
// f32, so the only roundings are the f32 sums and the store's single
// rounding to nearest even.  As in the split-TF32 paths, each stage's
// product goes to fresh accumulators that are added to the running sum in
// f32: the tensor cores' own accumulation truncates.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace egonn {

using bf16 = __nv_bfloat16;

// Cut-out variants of the bf16 conv and dW bodies, built only with
// EGONN_PROBE_CUTS (sparse/cuda_lib.py's probe libraries; probe_kernels.py
// bf16 times them to split a call's time; their outputs are not the
// function's): no MMA; no row gather (the stages still wait); no scan of the
// map (SM80 only; the conv: each group's compacted lists read from a copy
// that a compaction-only launch wrote up front; dW: no index read, every
// seventh row taken, the maps' density at L1-L2); the conv's map load and
// compaction alone; no weight loads (the Hopper conv: W^T's buffers are not
// filled).  The port's libraries hold kCutNone alone.
constexpr int kCutNone = 0, kCutNoMma = 1, kCutNoGather = 2, kCutNoMapScan = 3,
              kCutCompactOnly = 4, kCutNoWeights = 5;

// c (16x8, f32) += a (16x16, row) * b (16x8, col) on the tensor cores, bf16
// operands.  Per lane (g = lane / 4, t = lane % 4), each register holds two
// bf16, the lower index in the low half: a = A[g][2t, 2t+1], A[g+8][2t, 2t+1],
// A[g][2t+8, 2t+9], A[g+8][2t+8, 2t+9]; b = B[2t, 2t+1][g], B[2t+8, 2t+9][g];
// c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring bf16 of shared memory (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The fused eval epilogue on 4 neighbouring columns from `col`:
// keep ? relu?(v * scale + bias) : 0 (scale null: no affine).
__device__ __forceinline__ float4 epi4(float4 v, const float* scale, const float* bias, int col,
                                       int relu, bool keep) {
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
  return keep ? v : make_float4(0.f, 0.f, 0.f, 0.f);
}

// 4 outputs at dst (16 bytes of f32; 8 bytes of bf16, each rounded once to
// nearest even)
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(bf16* dst, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// One stage of a gathering body in bf16 (gather_mm.cuh, tdown.cu's
// tdown_gather_kernel): the warp multiplies the stage's 16-row tiles mg,
// mg + mg_step, ... of its n gathered rows (a_s, row stride lda) by its 16
// output columns (b_s: the W^T row of its first column, row stride ldb),
// kcp (a multiple of 16) deep, two independent 8-column accumulators fresh
// for the stage, and adds each product in f32 into the accumulator tile
// (acc_s, row stride ldc) at column `col` and row pairs[j] >> 24.  Within a
// stage each (row, column) has one owner.  Rows past n are never stored.
__device__ __forceinline__ void mma_stage_bf16(const bf16* a_s, int lda, const bf16* b_s, int ldb,
                                               const int* pairs, int n, int kcp, int mg,
                                               int mg_step, float* acc_s, int ldc, int col) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int mt = mg; mt * 16 < n; mt += mg_step) {
    const int j0 = mt * 16 + g, j1 = j0 + 8;  // this lane's rows
    const bool v0 = j0 < n, v1 = j1 < n;      // rows past n hold stale data
    const bf16* p0 = a_s + j0 * lda + 2 * t;
    const bf16* p1 = a_s + j1 * lda + 2 * t;
    float part[2][4];
#pragma unroll
    for (int e = 0; e < 8; ++e) part[e / 4][e % 4] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kcp; kk += 16) {
      uint32_t a[4];
      a[0] = v0 ? ld_pair(p0 + kk) : 0u;
      a[1] = v1 ? ld_pair(p1 + kk) : 0u;
      a[2] = v0 ? ld_pair(p0 + kk + 8) : 0u;
      a[3] = v1 ? ld_pair(p1 + kk + 8) : 0u;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* q = b_s + (nt * 8 + g) * ldb + kk + 2 * t;
        const uint32_t b[2] = {ld_pair(q), ld_pair(q + 8)};
        mma_bf16(part[nt], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = col + nt * 8 + 2 * t;
      if (v0) {
        float2* dst = reinterpret_cast<float2*>(acc_s + (pairs[j0] >> 24) * ldc + c);
        const float2 o = *dst;
        *dst = make_float2(o.x + part[nt][0], o.y + part[nt][1]);
      }
      if (v1) {
        float2* dst = reinterpret_cast<float2*>(acc_s + (pairs[j1] >> 24) * ldc + c);
        const float2 o = *dst;
        *dst = make_float2(o.x + part[nt][2], o.y + part[nt][3]);
      }
    }
  }
}

}  // namespace egonn
