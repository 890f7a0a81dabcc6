// Row quantization and MLP-epilogue helpers shared by the W8A8 kernels of
// this package (w8a8_matmul_sm90.cu, w8a8_mlp_sm90.cu): the rounding of
// `_row_quant` and of the int8 MLP's hidden, step by step, and the
// quantizer that writes a block of x's codes where int8 wgmma reads them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i8 {

constexpr float kEps = 1e-8f;
// the constant `1.0 / 127.0` of the JAX kernels, a double rounded to fp32
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

// the int8 code of v at inverse scale inv: rint(v * inv) (half to even, as
// jnp.round), clipped to +-127. v * inv is at most ~127.5 in magnitude, and
// adding 1.5 * 2^23 rounds any |f| < 2^22 to an integer, half to even, in
// the sum's low bits: the same integer as a float-to-int conversion, which
// runs at a quarter of the rate
__device__ __forceinline__ int quantize(float v, float inv) {
  constexpr float kRound = 12582912.0f;  // 1.5 * 2^23, bits 0x4B400000
  const int q = __float_as_int(__fadd_rn(__fmul_rn(v, inv), kRound)) - 0x4B400000;
  return min(max(q, -127), 127);
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

// Rows row0 .. row0 + 63 of the bf16 x (m, k) -> their int8 codes at `dst`
// in the 128-byte swizzle that TMA writes and wgmma reads (ceil(k / 128)
// tiles of 64 rows x 128 bytes, 8 KB apart: a swizzle row holds 128 int8 K
// values, and a k32 step is the same 32-byte advance of the descriptor as a
// bf16 k16 step) and their scales (`_row_quant`). Warp `warp` of the
// `nwarps` taking part quantizes rows warp, warp + nwarps, ..., the next
// row's loads in flight while this one is quantized; each lane holds 8
// values a 256-column piece (where k % 256 != 0 the last piece on the lanes
// below (k % 256) / 8 only: 8, 16 or 24 of them), the warp takes the
// absmax, every code is quantize(x, 1/s). Where k % 128 == 64 the last
// tile's second half is not written (the kernels' products skip it). With
// `given` (m floats), a row's absmax is given[row] instead (a tensor rank's
// share of the row: its absmax over the whole K). Rows past m get zero
// codes. k % 64 == 0 and k <= KMAX, 64 % nwarps == 0; x and dst 16-byte
// aligned.
template <int KMAX>
__device__ __forceinline__ void quantize_sw128(const __nv_bfloat16* __restrict__ x, int m,
                                               int k, int row0, unsigned char* dst,
                                               float* scales, int warp, int nwarps,
                                               const float* __restrict__ given = nullptr) {
  static_assert(KMAX % 128 == 0, "whole 128-byte swizzle rows");
  constexpr int PIECES = (KMAX + 255) / 256;
  const int lane = threadIdx.x % 32;
  // whether this lane holds columns of piece p
  auto held = [&](int p) { return p * 256 + lane * 8 < k; };
  // the raw bf16 of row r, zeros past 64, m or k
  auto load = [&](uint4 (&raw)[PIECES], int r) {
    const int row = row0 + r;
#pragma unroll
    for (int p = 0; p < PIECES; ++p)
      raw[p] = r < 64 && row < m && held(p)
                   ? *reinterpret_cast<const uint4*>(x + (size_t)row * k + p * 256 + lane * 8)
                   : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 raw[PIECES];
  load(raw, warp);
  for (int r = warp; r < 64; r += nwarps) {
    uint4 next[PIECES];
    load(next, r + nwarps);
    float v[PIECES][8];
    float amax = 0.f;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[p]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        v[p][2 * e] = f.x;
        v[p][2 * e + 1] = f.y;
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (given != nullptr) amax = row0 + r < m ? given[row0 + r] : 0.f;
    float s, inv;
    row_scale(amax, s, inv);
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      if (!held(p)) continue;
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= (static_cast<uint32_t>(quantize(v[p][e], inv)) & 0xffu) << (8 * e);
        hi |= (static_cast<uint32_t>(quantize(v[p][4 + e], inv)) & 0xffu) << (8 * e);
      }
      const int col = p * 256 + lane * 8, kk = col & 127;
      const int off = (col >> 7) * 8192 + r * 128 + ((((kk >> 4) ^ (r & 7)) << 4) | (kk & 15));
      *reinterpret_cast<uint2*>(dst + off) = make_uint2(lo, hi);
    }
    if (lane == 0) scales[r] = s;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) raw[p] = next[p];
  }
}

}  // namespace i8
