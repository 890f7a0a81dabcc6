// bf16 tensor-core helpers shared by the hand-written kernels of this package.
//
// One warp-wide `mma.sync.m16n8k16` (bf16 in, fp32 accumulate). Fragment
// layout, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k-major):    b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32):       c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// The element with the lower column (A) or lower k (B) sits in the low half
// of each 32-bit register.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace emm {

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two adjacent bf16 values as one register (lower address in the low half)
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two fp32 values rounded to bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two fp32 values as hi + lo bf16 pairs (`a` in the low halves), so that
// hi + lo carries 16 of fp32's 24 mantissa bits: two bf16 products, one of
// each part, stand in for a product with fp32 operands
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// two bf16 values from different rows, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

}  // namespace emm
