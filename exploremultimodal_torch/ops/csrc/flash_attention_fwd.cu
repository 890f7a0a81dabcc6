// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces two Pallas kernels of exploremultimodal_tpu/ops/flash_attention.py:
// `_attn_kernel` (:152, launched by `_fwd_call` :283) and, with DROP set,
// `_attn_drop_kernel` (:209, launched by `_fwd_drop_call` :323). It takes
// only rows of 256 < N <= 4096 keys (512 with DROP): shorter rows (every
// VLMo stream at 224^2) take flash_attention_fwd_sm90.cu, and the long
// forward (`_attn_long_kernel`) is flash_attention_long_sm90.cu. Same
// function: for each (batch*head, query row)
//   s   = (q . k^T) * scale + key_bias           fp32
//   p   = exp(s - max(s));  l = sum(p)
//   out = ((keep o p) . v) / l                   fp32 sum, stored as bf16
//   lse = max(s) + log(l)                       fp32, read by the backward
// where keep is 1 without dropout, and with DROP the hash mask of
// dropout_hash.cuh times 1 / (1 - rate). The mask multiplies the
// unnormalized p before the p . v product; l and lse stay clean, so the
// backward rebuilds the clean p from lse and re-applies the same mask.
//
// What bounds it on an H100: memory. At the VLMo shapes (N <= 237, head
// dim 64) it does 4*N*64 flops per 2*4*64 bytes of q/k/v/out, about N/2
// flops per byte, far below the ~295 flops per byte where the tensor cores
// would become the limit. So the design reads q, k and v once from device
// memory and writes out and lse once, and never writes the (N, N) scores.
//
// Design (simple first):
//   - one block of 4 warps per (64-row query tile, batch*head); each warp
//     owns 16 query rows and keeps its q fragments in registers;
//   - keys are walked in chunks of 64 through shared memory, with the
//     online-softmax rescaling (running max m, running sum l), which equals
//     the TPU kernel's full-row max within fp32 rounding;
//   - both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate). The TPU kernel multiplies fp32 p by v; here p is
//     split into hi + lo bf16 parts and multiplied twice, which keeps 16
//     mantissa bits of p (v is bf16, so exact) for one more mma per step;
//   - the ragged edge is masked in-kernel: k/v rows past N are zero-filled
//     and their bias is -1e30, so they add exactly 0 once a real key is seen.
//     The bias stays fp32 and finite (-1e30, never -inf), so no inf - inf.
// K and V chunks are loaded synchronously; a cp.async/TMA pipeline is work
// for a later change.

#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;       // head dim
constexpr int BQ = 64;      // query rows per block: 4 warps x 16
constexpr int BK = 64;      // keys per chunk
constexpr int LD = D + 8;   // smem row pitch (144 B): fragment loads are bank-conflict free
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

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

template <bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ out, float* __restrict__ lse, int n,
                 int heads, float scale, const int32_t* __restrict__ seed,
                 uint32_t threshold, float drop_scale) {
  __shared__ __align__(16) bf16 sQ[BQ][LD];
  __shared__ __align__(16) bf16 sK[BK][LD];
  __shared__ __align__(16) bf16 sV[BK][LD];
  __shared__ float sB[BK];

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t base = (size_t)bh * n * D;
  const float* key_bias = bias + (size_t)(bh / heads) * n;
  emm::DropKeys dkey{0u, 0u};
  if (DROP) dkey = emm::dropout_keys(*seed, bh);

  load_rows(sQ, q + base, q0, n);
  __syncthreads();

  // this warp's 16 query rows as A fragments, 4 k-steps over D
  const int r0 = warp * 16 + g;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = emm::ld32(&sQ[r0][c]);
    qa[kk][1] = emm::ld32(&sQ[r0 + 8][c]);
    qa[kk][2] = emm::ld32(&sQ[r0][c + 8]);
    qa[kk][3] = emm::ld32(&sQ[r0 + 8][c + 8]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // running max and sum of rows g (index 0) and g + 8 (index 1)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // every warp is done with the previous chunk
    load_rows(sK, k + base, k0, n);
    load_rows(sV, v + base, k0, n);
    for (int i = threadIdx.x; i < BK; i += THREADS)
      sB[i] = (k0 + i < n) ? key_bias[k0 + i] : NEG_INF;
    __syncthreads();

    // s = q . k^T for 16 rows x 64 keys: 8 tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        const uint32_t b[2] = {emm::ld32(&sK[j * 8 + g][c]),
                               emm::ld32(&sK[j * 8 + g][c + 8])};
        emm::mma_16816(s[j], qa[kk], b);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e] * scale + sB[j * 8 + 2 * t + (e & 1)];
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a row lives on the 4 lanes of a group
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
    if (DROP) {  // after the clean row sum: only p . v sees the mask
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] *= emm::dropout_keep(dkey, q0 + r0 + 8 * (e >> 1),
                                       k0 + j * 8 + 2 * t + (e & 1),
                                       threshold, drop_scale);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // o += p . v: the score C fragments of key tiles 2kk, 2kk+1 are the A
    // fragment of a 16-key step, split into hi + lo bf16 parts
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      emm::split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      emm::split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      emm::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      emm::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int d = j * 8 + g;
        const uint32_t b[2] = {emm::pack_bf16(sV[key][d], sV[key + 1][d]),
                               emm::pack_bf16(sV[key + 8][d], sV[key + 9][d])};
        emm::mma_16816(o[j], hi, b);
        emm::mma_16816(o[j], lo, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= n) continue;
    bf16* dst = out + base + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * h] / l[h], o[j][2 * h + 1] / l[h]);
    }
    if (t == 0) lse[(size_t)bh * n + row] = m[h] + logf(l[h]);
  }
}

template <bool DROP>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* seed, void* out, void* lse, int bh, int heads, int n,
           float scale, unsigned threshold, float drop_scale, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || n <= 0 || bh > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((n + BQ - 1) / BQ, bh);
  flash_fwd_kernel<DROP>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const float*>(bias),
          static_cast<bf16*>(out), static_cast<float*>(lse), n, heads, scale,
          static_cast<const int32_t*>(seed), threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (bh, n, 64) bf16 contiguous; bias: (bh / heads, n) fp32;
// lse: (bh, n) fp32. Launches on `stream`; returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, void* lse,
                                   int bh, int heads, int n, float scale,
                                   void* stream) {
  return launch<false>(q, k, v, bias, nullptr, out, lse, bh, heads, n, scale,
                       0u, 0.f, stream);
}

// As flash_attention_fwd, with attention dropout: `seed` is one int32 on the
// device; an element is kept where its hash bits >= `threshold`
// (min(int(rate * 2^32), 2^32 - 1)) and then scaled by `drop_scale`.
extern "C" int flash_attention_fwd_drop(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        const void* seed, void* out, void* lse,
                                        int bh, int heads, int n, float scale,
                                        unsigned threshold, float drop_scale,
                                        void* stream) {
  return launch<true>(q, k, v, bias, seed, out, lse, bh, heads, n, scale,
                      threshold, drop_scale, stream);
}
