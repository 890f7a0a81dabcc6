// Long-sequence flash-attention forward for Hopper (sm_90a) on wgmma and TMA.
//
// Replaces the Pallas kernel `_attn_long_kernel`
// (exploremultimodal_tpu/ops/flash_attention.py:113, launched by
// `_long_fwd_call` :553), the k-blocked online-softmax forward that the
// JAX package takes past a padded N of 4096 and that returns the output
// only. Same function: for each (batch*head, query row)
//   s   = (q . k^T) * scale + key_bias           fp32
//   p   = exp(s - max(s));  l = sum(p)
//   out = (p . v) / l                            fp32 sum, stored as bf16
// with bf16 q, k, v (head dim 64) and an fp32 (B, N) key bias.
//
// What bounds it on an H100: operations. It does 4 BH N^2 D flops against
// 8 BH N D bytes of q, k, v and out, N / 2 flops per byte: at the 1024^2
// request's N = 4097 / 4137 about 2,000, far above the ~295 where the
// tensor cores become the limit (420.6 GFLOP at BH = 96, N = 4137: 0.4253
// ms at 989 TFLOP/s).
//
// Design (right and simple first):
//   - A CTA owns 128 query rows of one (b, h): two consumer warpgroups of
//     64 rows each on wgmma, and one producer warp (`setmaxnreg` moves
//     registers from the producer to the consumers). Grid: query tiles x
//     BH, tiles fastest, so the CTAs of one head run together and share its
//     K and V in L2.
//   - Q (16 KB) is loaded once by TMA; K and V come in 128-key blocks (16 KB
//     each) through a ring of NS stages on mbarriers. The maps are 3D over
//     (D, N, BH), so a box stops at its head's N and TMA fills the ragged
//     block with zeros (a 2D map over BH N rows would read the next head).
//   - The key bias, whose (B, N) fp32 rows are 4 N bytes apart (not a
//     multiple of 16 at odd N, so no tensor map), is read by the producer
//     warp with plain loads into the stage, times log2(e), -1e30 past N:
//     finite, never -inf, so no inf - inf. The consumers then read it from
//     shared memory.
//   - S = Q K^T: wgmma m64n128k16 with both operands in shared memory (the
//     128-byte swizzle TMA writes), four k steps over D, 64 fp32 registers a
//     thread. scale * log2(e) is folded in and p = exp2(s - m); the running
//     max m is reduced over the four lanes that share a row, the running sum
//     l stays a per-thread partial until the end.
//   - O += P V: wgmma m64n64k16 with P from registers (the m64n128
//     accumulator's fragment, packed to bf16 pairs, is the A operand of its
//     k16 slices) and V from shared memory read MN-major (transposed), so V
//     needs no transpose; O is 32 fp32 registers a thread.
//   - Precision of p: with HILO p is split into hi + lo bf16 parts and P V
//     runs twice, which keeps 16 mantissa bits of p (v is bf16, exact); the
//     output then stays within one bf16 ulp of the fp32 plain version. A
//     single bf16 p halves the P V products (a variant in
//     scripts/torch_kernel_variants.json measures both).
//   - Finish: O / l, stored as bf16 for rows < N. No lse.
// Left for later: ping-pong scheduling of the two warpgroups (here each
// runs S, softmax and P V in turn, and the tensor cores idle while both
// are in softmax), overlap of a block's softmax with the next block's
// Q K^T, and persistent CTAs.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace emm::sm90;

constexpr int D = 64;        // head dim
constexpr int BQ = 128;      // query rows per CTA: two warpgroups of 64
constexpr int BK = 128;      // keys per block
constexpr int NS = 3;        // ring stages (K, V and bias of one block each)
constexpr bool HILO = true;  // p as hi + lo bf16 parts
constexpr int TILE = BK * D * 2;  // 16 KB: one K or V block, or Q
constexpr int Q_OFF = 0;
constexpr int K_OFF = Q_OFF + TILE;
constexpr int V_OFF = K_OFF + NS * TILE;
constexpr int BIAS_OFF = V_OFF + NS * TILE;  // NS x BK fp32
constexpr int BAR_OFF = BIAS_OFF + NS * BK * 4;
constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * NS) + 1024;  // + alignment slack
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f;
static_assert(BQ == 2 * 64 && TILE == BQ * D * 2, "Q shares the K/V box");
static_assert(SMEM <= 232448, "shared memory");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// q, k, v through their (D, n, bh) maps in (64, 128, 1) boxes; bias (bh /
// heads, n) fp32; out (bh, n, D) bf16. scale_log2 = scale * log2(e).
__global__ void __launch_bounds__(THREADS, 1)
attn_long_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, const float* __restrict__ bias,
                      bf16* __restrict__ out, int n, int heads, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* sbias = reinterpret_cast<float*>(smem_raw + (base - raw) + BIAS_OFF);
  const uint32_t qfull = base + BAR_OFF, full0 = qfull + 8, empty0 = full0 + 8 * NS;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int blocks = (n + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes (one with the bytes)
      mbar_init(empty0 + 8 * s, 8);  // each consumer warp, once its reads are done
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == 2) {
    // ---- producer: warp 8 loads; lane 0 starts every TMA
    setmaxnreg_dec<24>();
    if (threadIdx.x / 32 != 8) return;
    const float* kb = bias + (size_t)(bh / heads) * n;
    if (lane == 0) {
      mbar_arrive_expect_tx(qfull, TILE);
      tma_load_3d(base + Q_OFF, &mq, qfull, 0, q0, bh);
    }
    for (int j = 0; j < blocks; ++j) {
      const int s = j % NS;
      mbar_wait(empty0 + 8 * s, ((j / NS) & 1) ^ 1);
      for (int i = lane; i < BK; i += 32) {
        const int key = j * BK + i;
        sbias[s * BK + i] = (key < n ? kb[key] : MASKED) * LOG2E;
      }
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        mbar_arrive_expect_tx(full, 2 * TILE);
        tma_load_3d(base + K_OFF + s * TILE, &mk, full, 0, j * BK, bh);
        tma_load_3d(base + V_OFF + s * TILE, &mv, full, 0, j * BK, bh);
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows q0 + 64 w ..
  setmaxnreg_inc<240>();
  const int w = wg, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, qd = lane % 4;
  const uint32_t sq = base + Q_OFF + w * (TILE / 2);
  // rows 16 warp + g (h = 0) and + 8 (h = 1) of this warpgroup's 64
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // m starts at the masked keys' score, so a -inf bias gives p = 0, no NaN,
  // and a row with every key masked averages them as the plain version does
  float m[2] = {MASKED * LOG2E, MASKED * LOG2E}, l[2] = {0.f, 0.f};
  mbar_wait(qfull, 0);

  for (int j = 0; j < blocks; ++j) {
    const int s = j % NS;
    mbar_wait(full0 + 8 * s, (j / NS) & 1);
    const uint32_t sk = base + K_OFF + s * TILE, sv = base + V_OFF + s * TILE;

    // S (64 x 128) = Q K^T
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss_n128(sc, desc_sw128(sq + 32 * k), desc_sw128(sk + 32 * k));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scores in log2 units, the block's row max
    const float* sb = sbias + s * BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float2 b = *reinterpret_cast<const float2*>(sb + 8 * jj + 2 * qd);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x0 = fmaf(sc[4 * jj + 2 * h], scale_log2, b.x);
        const float x1 = fmaf(sc[4 * jj + 2 * h + 1], scale_log2, b.y);
        sc[4 * jj + 2 * h] = x0;
        sc[4 * jj + 2 * h + 1] = x1;
        mx[h] = fmaxf(mx[h], fmaxf(x0, x1));
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a row lives on the 4 lanes of a quad
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);  // 0 from the masked start to a real key
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];

    // p, packed as the A fragments of the 8 k16 slices of P V
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // register r of slice kk: key tile 2 kk + (r >> 1), row half r & 1
        const int jj = 2 * kk + (r >> 1), h = r & 1;
        const float p0 = exp2f(sc[4 * jj + 2 * h] - m[h]);
        const float p1 = exp2f(sc[4 * jj + 2 * h + 1] - m[h]);
        l[h] += p0 + p1;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(p0, p1);
        hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hv);
        if (HILO) {
          const float2 hf = __bfloat1622float2(hv);
          lo[kk][r] = pack_bf16(p0 - hf.x, p1 - hf.y);
        }
      }
    }

    // O (64 x 64) += P V
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv = desc_sw128(sv + kk * 2048);
      wgmma_rs_n64_mn(o, hi[kk], dv);
      if (HILO) wgmma_rs_n64_mn(o, lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // finish: O / l for rows < n
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + 64 * w + 16 * warp + g + 8 * h;
    if (row >= n) continue;
    bf16* dst = out + ((size_t)bh * n + row) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj + 2 * qd) =
          __floats2bfloat162_rn(o[4 * jj + 2 * h] / l[h], o[4 * jj + 2 * h + 1] / l[h]);
  }
}

}  // namespace

// Encodes into `out` (128 bytes, host memory) the bf16 tensor map at `base`
// with the given extents: `rank` dims innermost first, the byte strides of
// dims 1.., the box. Returns a cudaError_t.
extern "C" int flash_attention_long_sm90_encode(void* out, const void* base, int rank,
                                                const uint64_t* dims,
                                                const uint64_t* strides_bytes,
                                                const uint32_t* box) {
  if (rank != 3 || box[0] != D || box[1] != BK || box[2] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return emm_encode_bf16_map(out, base, rank, dims, strides_bytes, box);
}

// mq, mk, mv: the maps of q, k, v (bh, n, 64) bf16 (from
// `flash_attention_long_sm90_encode`, host memory); bias (bh / heads, n)
// fp32; out (bh, n, 64) bf16; `tiles` = ceil(n / 128) query tiles. Launches
// on `stream`; returns the launch's cudaError_t.
extern "C" int flash_attention_long_sm90(const void* mq, const void* mk, const void* mv,
                                         const void* bias, void* out, int bh, int heads, int n,
                                         int tiles, float scale, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || n <= 0 || bh > 65535 ||
      tiles != (n + BQ - 1) / BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q, k, v;
  memcpy(&q, mq, sizeof(q));
  memcpy(&k, mk, sizeof(k));
  memcpy(&v, mv, sizeof(v));
  cudaError_t err = cudaFuncSetAttribute(attn_long_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_long_sm90_kernel<<<dim3(tiles, bh), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, static_cast<const float*>(bias), static_cast<bf16*>(out), n, heads,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
