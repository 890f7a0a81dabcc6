// Flash-attention backward for Hopper (sm_90a), bf16 in and out, fp32 math.
//
// Replaces two Pallas kernels of exploremultimodal_tpu/ops/flash_attention.py:
// `_attn_bwd_kernel` (:170, launched by `_bwd_call` :395) and, with DROP set,
// `_attn_drop_bwd_kernel` (:237, launched by `_bwd_drop_call` :362), for
// rows of 256 < N <= 512 keys: shorter rows (every VLMo stream at 224^2)
// take flash_attention_bwd_sm90.cu. Same function: for each batch*head, with p = exp(s - lse) the clean
// probabilities rebuilt from the forward's lse and keep the forward's mask
// (1 without dropout; dropout_hash.cuh times 1 / (1 - rate) with it),
//   delta = rowsum(do o o)
//   dv    = (keep o p)^T . do
//   ds    = p o ((do . v^T) o keep - delta)
//   dq    = ds . k * scale,   dk = ds^T . q * scale
// With the mask, delta = rowsum(do o o) still equals sum_j dP_ij P_ij of the
// dropped probabilities, so it needs no extra pass (`_attn_drop_bwd_kernel`).
//
// What bounds it on an H100: memory. At the VLMo shapes (N <= 237, head dim
// 64) the backward does ~10*N*64 flops per 8*64*2 bytes of q/k/v/o/do and
// dq/dk/dv, about N flops per byte, below the ~295 where the tensor cores
// would be the limit. The TPU kernel holds one batch*head whole and keeps
// about four (N, N) fp32 tiles in VMEM; at N = 237 one such tile is 225 KB,
// more than a Hopper block's shared memory. So the work is tiled over
// 64-row blocks, FlashAttention-2 style, and no (N, N) tile reaches device
// memory:
//   - flash_bwd_dq_kernel: one block per (64 query rows, batch*head). It
//     computes delta for its rows from o and do (written for the second
//     kernel, as the TPU kernel computes it in-kernel), then walks 64-key
//     chunks: s, p, dp, ds, and dq += ds . k in registers.
//   - flash_bwd_dkdv_kernel: one block per (64 keys, batch*head). It walks
//     64-query chunks: s^T, p^T, dp^T, ds^T, and dv += (keep o p)^T . do,
//     dk += ds^T . q in registers.
// dq is reduced over all keys inside one block, so the backward is
// deterministic (no fp32 atomics, no workspace cast pass). The price is
// computing s and dp twice (7 products instead of 5), which the memory
// bound leaves room for.
//
// Precision: q, k, v, o and do are bf16, so they enter the tensor cores
// exactly. p and ds are fp32 in the TPU kernel; here each is split into
// hi + lo bf16 parts and multiplied twice, which keeps 16 mantissa bits.
// Ragged edges are masked in-kernel: keys past N are zero-filled with a
// -1e30 bias (p = 0), queries past N are zero-filled with lse = 1e30 and
// delta = 0 (p = 0), so they add exactly 0. Every warp runs mma.sync
// m16n8k16; loads are synchronous (a cp.async/TMA pipeline is later work).

#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;      // head dim
constexpr int BR = 64;     // rows a block owns: 4 warps x 16
constexpr int BC = 64;     // rows of the other operand per chunk
constexpr int SUB = 32;    // chunk columns a warp holds in registers at once
constexpr int LD = D + 8;  // smem row pitch (144 B), as in the forward
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LSE_PAD = 1e30f;

// rows [row0, row0 + 64) of a (n, D) bf16 matrix into smem, zero past n
__device__ __forceinline__ void load_rows(bf16 (*dst)[LD], const bf16* src,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < 64 * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

// A fragments (16 rows x D) of smem rows [r, r + 16)
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4],
                                       bf16 (*src)[LD], int r, int g,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = emm::ld32(&src[r + g][c]);
    a[kk][1] = emm::ld32(&src[r + g + 8][c]);
    a[kk][2] = emm::ld32(&src[r + g][c + 8]);
    a[kk][3] = emm::ld32(&src[r + g + 8][c + 8]);
  }
}

// acc (16 x SUB) = A (16 x D) . M[col0 : col0 + SUB]^T, M rows in smem
__device__ __forceinline__ void product_nt(float acc[SUB / 8][4],
                                           uint32_t a[D / 16][4],
                                           bf16 (*m)[LD], int col0,
                                           int g, int t) {
#pragma unroll
  for (int j = 0; j < SUB / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      const uint32_t b[2] = {emm::ld32(&m[col0 + j * 8 + g][c]),
                             emm::ld32(&m[col0 + j * 8 + g][c + 8])};
      emm::mma_16816(acc[j], a[kk], b);
    }
  }
}

// out (16 x D) += X (16 x SUB, fp32 C fragments) . M[row0 : row0 + SUB],
// M rows in smem; X goes in as hi + lo bf16 parts
__device__ __forceinline__ void product_nn(float out[D / 8][4],
                                           float x[SUB / 8][4],
                                           bf16 (*m)[LD], int row0,
                                           int g, int t) {
#pragma unroll
  for (int kk = 0; kk < SUB / 16; ++kk) {
    uint32_t hi[4], lo[4];
    emm::split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    emm::split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    emm::split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    emm::split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
    const int r = row0 + kk * 16 + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + g;
      const uint32_t b[2] = {emm::pack_bf16(m[r][d], m[r + 1][d]),
                             emm::pack_bf16(m[r + 8][d], m[r + 9][d])};
      emm::mma_16816(out[j], hi, b);
      emm::mma_16816(out[j], lo, b);
    }
  }
}

// rows [row, row + 8) and [row + 8, row + 16) of a 16 x D C fragment
// accumulator, times `mul`, to bf16 global rows below n
__device__ __forceinline__ void store_rows(bf16* dst, float acc[D / 8][4],
                                           int row, int n, int t, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= n) continue;
    bf16* p = dst + (size_t)(row + 8 * h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int n, int heads, float scale,
                    const int32_t* __restrict__ seed, uint32_t threshold,
                    float drop_scale) {
  __shared__ __align__(16) bf16 sQ[BR][LD];
  __shared__ __align__(16) bf16 sDO[BR][LD];
  __shared__ __align__(16) bf16 sK[BC][LD];
  __shared__ __align__(16) bf16 sV[BC][LD];
  __shared__ float sB[BC];
  __shared__ float sDelta[BR];

  const int bh = blockIdx.y, q0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t base = (size_t)bh * n * D;
  const float* key_bias = bias + (size_t)(bh / heads) * n;
  emm::DropKeys dkey{0u, 0u};
  if (DROP) dkey = emm::dropout_keys(*seed, bh);

  load_rows(sQ, q + base, q0, n);
  load_rows(sDO, dout + base, q0, n);
  load_rows(sK, o + base, q0, n);  // o, for delta only
  __syncthreads();
  {  // delta = rowsum(do o o): two threads per row
    const int r = threadIdx.x / 2, c0 = (threadIdx.x % 2) * (D / 2);
    float acc = 0.f;
#pragma unroll 8
    for (int c = c0; c < c0 + D / 2; ++c)
      acc += __bfloat162float(sDO[r][c]) * __bfloat162float(sK[r][c]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    const bool real = q0 + r < n;
    if (threadIdx.x % 2 == 0) {
      sDelta[r] = real ? acc : 0.f;
      if (real) delta[(size_t)bh * n + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int rw = warp * 16;  // this warp's rows: q0 + rw + g (+ 8)
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a(qa, sQ, rw, g, t);
  load_a(da, sDO, rw, g, t);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rw + g + 8 * h;
    row_lse[h] = row < n ? lse[(size_t)bh * n + row] : LSE_PAD;
    row_delta[h] = sDelta[rw + g + 8 * h];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BC) {
    __syncthreads();  // every warp is done with the previous chunk
    load_rows(sK, k + base, k0, n);
    load_rows(sV, v + base, k0, n);
    for (int i = threadIdx.x; i < BC; i += THREADS)
      sB[i] = (k0 + i < n) ? key_bias[k0 + i] : NEG_INF;
    __syncthreads();

#pragma unroll
    for (int sub = 0; sub < BC; sub += SUB) {
      float s[SUB / 8][4], dp[SUB / 8][4];
      product_nt(s, qa, sK, sub, g, t);   // q . k^T
      product_nt(dp, da, sV, sub, g, t);  // do . v^T
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sub + j * 8 + 2 * t + (e & 1);
          const float p = expf(s[j][e] * scale + sB[col] - row_lse[e >> 1]);
          float d = dp[j][e];
          if (DROP)
            d *= emm::dropout_keep(dkey, q0 + rw + g + 8 * (e >> 1), k0 + col,
                                   threshold, drop_scale);
          s[j][e] = p * (d - row_delta[e >> 1]);  // ds
        }
      product_nn(acc, s, sK, sub, g, t);  // dq += ds . k
    }
  }
  store_rows(dq + base, acc, q0 + rw + g, n, t, scale);
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int n, int heads, float scale,
                      const int32_t* __restrict__ seed, uint32_t threshold,
                      float drop_scale) {
  __shared__ __align__(16) bf16 sQ[BC][LD];
  __shared__ __align__(16) bf16 sDO[BC][LD];
  __shared__ float sLse[BC];
  __shared__ float sDelta[BC];

  const int bh = blockIdx.y, k0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t base = (size_t)bh * n * D;
  const float* key_bias = bias + (size_t)(bh / heads) * n;
  emm::DropKeys dkey{0u, 0u};
  if (DROP) dkey = emm::dropout_keys(*seed, bh);

  // this warp's 16 keys as A fragments, staged through the chunk buffers
  const int rw = warp * 16;  // keys k0 + rw + g (+ 8)
  load_rows(sQ, k + base, k0, n);
  load_rows(sDO, v + base, k0, n);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a(ka, sQ, rw, g, t);
  load_a(va, sDO, rw, g, t);
  float kbias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + rw + g + 8 * h;
    kbias[h] = key < n ? key_bias[key] : NEG_INF;
  }

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc_dk[j][0] = acc_dk[j][1] = acc_dk[j][2] = acc_dk[j][3] = 0.f;
    acc_dv[j][0] = acc_dv[j][1] = acc_dv[j][2] = acc_dv[j][3] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += BC) {
    __syncthreads();  // every warp is done with the previous chunk
    load_rows(sQ, q + base, q0, n);
    load_rows(sDO, dout + base, q0, n);
    for (int i = threadIdx.x; i < BC; i += THREADS) {
      const bool real = q0 + i < n;
      sLse[i] = real ? lse[(size_t)bh * n + q0 + i] : LSE_PAD;
      sDelta[i] = real ? delta[(size_t)bh * n + q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int sub = 0; sub < BC; sub += SUB) {
      float pt[SUB / 8][4], dpt[SUB / 8][4];
      product_nt(pt, ka, sQ, sub, g, t);    // (q . k^T)^T
      product_nt(dpt, va, sDO, sub, g, t);  // (do . v^T)^T
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sub + j * 8 + 2 * t + (e & 1);  // query in chunk
          const float p =
              expf(pt[j][e] * scale + kbias[e >> 1] - sLse[col]);
          float keep = 1.f;
          if (DROP)
            keep = emm::dropout_keep(dkey, q0 + col, k0 + rw + g + 8 * (e >> 1),
                                     threshold, drop_scale);
          dpt[j][e] = p * (dpt[j][e] * keep - sDelta[col]);  // ds^T
          pt[j][e] = p * keep;
        }
      product_nn(acc_dv, pt, sDO, sub, g, t);  // dv += (keep o p)^T . do
      product_nn(acc_dk, dpt, sQ, sub, g, t);  // dk += ds^T . q
    }
  }
  store_rows(dk + base, acc_dk, k0 + rw + g, n, t, scale);
  store_rows(dv + base, acc_dv, k0 + rw + g, n, t, 1.f);
}

template <bool DROP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* o, const void* dout, const void* lse, void* delta,
           const void* seed, void* dq, void* dk, void* dv, int bh, int heads,
           int n, float scale, unsigned threshold, float drop_scale,
           void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || n <= 0 || bh > 65535)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + BR - 1) / BR, bh);
  const auto* q_ = static_cast<const bf16*>(q);
  const auto* k_ = static_cast<const bf16*>(k);
  const auto* v_ = static_cast<const bf16*>(v);
  const auto* b_ = static_cast<const float*>(bias);
  const auto* do_ = static_cast<const bf16*>(dout);
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* seed_ = static_cast<const int32_t*>(seed);
  // dq first: it writes delta, which the dk/dv kernel reads
  flash_bwd_dq_kernel<DROP><<<grid, THREADS, 0, st>>>(
      q_, k_, v_, b_, static_cast<const bf16*>(o), do_, lse_,
      static_cast<float*>(delta), static_cast<bf16*>(dq), n, heads, scale,
      seed_, threshold, drop_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<DROP><<<grid, THREADS, 0, st>>>(
      q_, k_, v_, b_, do_, lse_, static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, heads, scale, seed_,
      threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, n, 64) bf16 contiguous; bias:
// (bh / heads, n) fp32; lse: (bh, n) fp32 from the forward; delta: (bh, n)
// fp32 scratch. Launches two kernels on `stream`; returns the first
// launch error as cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int bh, int heads, int n, float scale,
                                   void* stream) {
  return launch<false>(q, k, v, bias, o, dout, lse, delta, nullptr, dq, dk, dv,
                       bh, heads, n, scale, 0u, 0.f, stream);
}

// As flash_attention_bwd, with the forward's dropout mask regenerated from
// the same device int32 `seed`, `threshold` and `drop_scale`.
extern "C" int flash_attention_bwd_drop(
    const void* q, const void* k, const void* v, const void* bias,
    const void* seed, const void* o, const void* dout, const void* lse,
    void* delta, void* dq, void* dk, void* dv, int bh, int heads, int n,
    float scale, unsigned threshold, float drop_scale, void* stream) {
  return launch<true>(q, k, v, bias, o, dout, lse, delta, seed, dq, dk, dv, bh,
                      heads, n, scale, threshold, drop_scale, stream);
}
