// int8 tensor-core, cp.async, row-quantization and MLP-epilogue helpers
// shared by the W8A8 kernels of this package (w8a8_matmul.cu,
// w8a8_mlp_sm90.cu).
//
// One warp-wide `mma.sync.m16n8k32` (s8 in, s32 accumulate). Fragment
// layout, with g = lane / 4 and t = lane % 4, in bytes of a 32-wide k slice
// (the same byte positions as mma_bf16.cuh's m16n8k16):
//   A (16 x 32, row-major): a0 = A[g][4t..4t+3],    a1 = A[g+8][4t..4t+3],
//                           a2 = A[g][16+4t..+3],   a3 = A[g+8][16+4t..+3]
//   B (32 x 8, k-major, so rows of an (N, K) matrix): b0 = B[4t..4t+3][g],
//                           b1 = B[16+4t..+3][g]
//   C (16 x 8, s32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// The element with the lower k sits in the lowest byte of each register.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i8 {

constexpr float kEps = 1e-8f;
// the constant `1.0 / 127.0` of the JAX kernels, a double rounded to fp32
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ void mma_16832(int c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four adjacent int8 values as one register (lowest address in the low byte)
__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragment (16 x 32) at rows r0.., byte columns col.. of an int8 tile;
// col = 32 * kstep + 4 * t
__device__ __forceinline__ void load_a(uint32_t a[4], const int8_t* tile,
                                       int pitch, int r0, int col) {
  a[0] = ld32(tile + r0 * pitch + col);
  a[1] = ld32(tile + (r0 + 8) * pitch + col);
  a[2] = ld32(tile + r0 * pitch + col + 16);
  a[3] = ld32(tile + (r0 + 8) * pitch + col + 16);
}

// 16 bytes global -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most `N` of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// starts copying `rows` rows of `row_bytes` bytes (a multiple of 16) in
// 16-byte pieces; pitches in bytes; rows from `valid_rows` on are zero-filled
__device__ __forceinline__ void load_rows_async(void* dst, int dst_pitch,
                                                const void* src,
                                                size_t src_pitch, int rows,
                                                int row_bytes,
                                                int valid_rows) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const int per_row = row_bytes / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 16;
    const bool ok = r < valid_rows;
    cp_async16(d + r * dst_pitch + c, s + (size_t)(ok ? r : 0) * src_pitch + c,
               ok);
  }
}

// the int8 code of v at inverse scale inv: rint(v * inv) (half to even, as
// jnp.round), clipped to +-127
__device__ __forceinline__ int quantize(float v, float inv) {
  return min(max(__float2int_rn(__fmul_rn(v, inv)), -127), 127);
}

// The row scale s = max(absmax, 1e-8) * (1/127) and its reciprocal 1/s,
// each rounded once, as `_row_quant` computes them.
__device__ __forceinline__ void row_scale(float absmax, float& s, float& inv) {
  s = __fmul_rn(fmaxf(absmax, kEps), kInv127);
  inv = __frcp_rn(s);
}

// the tanh-form gelu of `_mlp_kernel`, 0.5 * h * (1 + tanh(0.79788... * (h +
// 0.044715 * h * h * h))), in the order the Pallas kernel writes it, every
// product and sum rounded once (no FMA contraction)
__device__ __forceinline__ float gelu_tanh(float h) {
  constexpr float c0 = static_cast<float>(0.044715);
  constexpr float c1 = static_cast<float>(0.7978845608028654);
  const float u = __fmul_rn(c1, __fadd_rn(h, __fmul_rn(__fmul_rn(__fmul_rn(c0, h), h), h)));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, tanhf(u)));
}

// one hidden value of the int8 MLP from its int32 sum: gelu((acc * sx) *
// sw1 + b1), dequantized with the row's and the column's scales
__device__ __forceinline__ float hidden(int acc, float sx, float sw1, float b1) {
  return gelu_tanh(__fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw1), b1));
}

// Quantizes rows row0 .. row0 + nrows - 1 of the bf16 x (m, K) into int8
// codes at dst (pitch `ld` bytes, ld % 8 == 0) and their scales into
// `scales`, one warp per row (`_row_quant`): each lane holds K / 32 values
// of the row, the warp takes the absmax, and every code is
// quantize(x, 1/s). Rows at or beyond m get zero codes. K % 256 == 0; x and
// dst 16-byte aligned.
template <int K>
__device__ void quantize_rows(const __nv_bfloat16* __restrict__ x, int m,
                              int row0, int8_t* dst, int ld, float* scales,
                              int nrows) {
  static_assert(K % 256 == 0, "8 values a lane per 256 columns");
  constexpr int PIECES = K / 256;
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < nrows; r += nwarps) {
    const int row = row0 + r;
    float v[PIECES][8];
    float amax = 0.f;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row < m)
        raw = *reinterpret_cast<const uint4*>(x + (size_t)row * K + p * 256 + lane * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        v[p][2 * e] = f.x;
        v[p][2 * e + 1] = f.y;
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    float s, inv;
    row_scale(amax, s, inv);
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= (static_cast<uint32_t>(quantize(v[p][e], inv)) & 0xffu) << (8 * e);
        hi |= (static_cast<uint32_t>(quantize(v[p][4 + e], inv)) & 0xffu) << (8 * e);
      }
      *reinterpret_cast<uint2*>(dst + r * ld + p * 256 + lane * 8) = make_uint2(lo, hi);
    }
    if (lane == 0) scales[r] = s;
  }
}

}  // namespace i8
