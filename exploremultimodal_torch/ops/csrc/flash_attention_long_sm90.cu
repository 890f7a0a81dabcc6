// Streamed flash-attention forward for Hopper (sm_90a) on wgmma and TMA: K
// and V stream through shared memory in 128-key blocks, so it takes rows of
// any length.
//
// Replaces three Pallas kernels of exploremultimodal_tpu/ops/flash_attention.py:
//   - `_attn_long_kernel` (:113, launched by `_long_fwd_call` :561), the
//     k-blocked online-softmax forward that the JAX package takes past a
//     padded N of 4096 and that returns the output only (row 5);
//   - with LSE, `_attn_kernel` (:152, launched by `_fwd_call` :291), the
//     full-row forward with its lse, for 256 < N and padded N <= 4096 (row
//     1);
//   - with LSE and DROP, `_attn_drop_kernel` (:209, launched by
//     `_fwd_drop_call` :329), the same with the hashed dropout mask, for
//     256 < N <= 512 (row 3).
// Rows of up to 256 keys take flash_attention_fwd_sm90.cu, which holds a
// head's whole K and V. Same function: for each (batch*head, query row)
//   s   = (q . k^T) * scale + key_bias           fp32
//   p   = exp(s - max(s));  l = sum(p)
//   out = ((keep o p) . v) / l                   fp32 sum, stored as bf16
//   lse = max(s) + log(l)                        fp32 (LSE), read by the backward
// with bf16 q, k, v (head dim D: 64, or vlmo_debug's 32) and an fp32 (B, N)
// key bias. keep is 1
// without DROP; with it, the hash mask of dropout_hash.cuh times 1 / (1 -
// rate), applied after the row sum, so l and lse stay clean and the
// backward rebuilds the clean p from lse. The TPU kernels of rows 1 and 3
// take the row max over all N keys at once; here it is a running max, and
// the result agrees within fp32 rounding.
//
// What bounds it on an H100: operations. It does 4 BH N^2 D flops against
// 8 BH N D bytes of q, k, v and out, N / 2 flops per byte: 128-256 at N =
// 257-512, about the ~295 where the tensor cores become the limit, and
// ~2,000 at the 1024^2 request's N = 4097 / 4137 (420.6 GFLOP at BH = 96,
// N = 4137: 0.4253 ms at 989 TFLOP/s). Row 3 also hashes every (row, key)
// on the ALUs.
//
// What holds it back (scripts/torch_kernel_variants.py on an H100 at BH =
// 384, N = 512): row 1 0.110 ms, 3.6x its bound, with the softmax on the
// ALUs between the products (one bf16 p would take 12% off and leaves the
// tolerance); row 3 0.177 ms, of which the hash is 0.067 (without the mask
// 0.110).
//
// Design:
//   - A work item is 128 query rows of one (b, h): two consumer warpgroups
//     of 64 rows each on wgmma, and one producer warp (`setmaxnreg` moves
//     registers from the producer to the consumers). Items are numbered
//     with the query tile fastest, so the items in flight at once belong
//     to few heads and share their K and V in L2.
//   - Persistent CTAs, one per SM or one per item where there are fewer:
//     CTA c takes items c, c + grid, ... A CTA for each item paid its
//     first loads in every item, 4 blocks at N = 512: row 1 at BH = 384
//     took 0.1362 ms that way on an H100, 0.1205 persistent.
//   - Q (16 KB) is loaded by TMA into one of QS slots, so the next item's Q
//     lands while this item runs; K and V come in 128-key blocks (16 KB
//     each) through a ring of NS stages on mbarriers, one running position
//     over all of a CTA's items, so the next item's first blocks load
//     under this item's last. The maps are 3D over
//     (D, N, BH), so a box stops at its head's N and TMA fills the ragged
//     block with zeros (a 2D map over BH N rows would read the next head).
//     Rows 1 and 3 stream K and V through this ring rather than through
//     the short kernel's head slots: a slot holds a head's whole K and V
//     (100 KB at 256 keys), and slabs of 64 keys through those slots would
//     halve each product's width; the ring is already the one row 5 runs.
//   - Both consumer warpgroups read every stage and every Q slot, and each
//     of their 8 warps releases it on its empty barrier (count 8), so the
//     producer reloads a stage or slot only once both are done with it. A
//     warpgroup can then be at most one ring's length ahead of the other,
//     waiting for a load that needs the other's release first, and a
//     parity wait never meets the phase two before its own
//     (tests/test_torch_port_sm90_host.py models this ring).
//   - The key bias, whose (B, N) fp32 rows are 4 N bytes apart (not a
//     multiple of 16 at odd N, so no tensor map), is read by the producer
//     warp with plain loads into the stage, times log2(e), -inf past N. The
//     consumers then read it from shared memory.
//   - S = Q K^T: wgmma m64n128k16 with both operands in shared memory (the
//     128-byte swizzle TMA writes), four k steps over D, 64 fp32 registers a
//     thread. scale * log2(e) is folded in and p = 2^(s - m) (ex2.approx,
//     subnormals flushed); the running
//     max m is reduced over the four lanes that share a row, the running sum
//     l stays a per-thread partial until the end. m starts at the score of a
//     -1e30 bias, finite: keys past N (-inf) add exactly 0 and never meet
//     inf - inf, and a row whose real keys are all masked averages them as
//     the plain version does.
//   - DROP: before the turn that makes a block's scores (while its load is
//     in flight), each consumer thread hashes its 64 (row, key) pairs of the
//     block into two words of keep bits; after p is added to l and before
//     the hi + lo split, p becomes p * scale where its bit is set and 0
//     where not. The short kernel spilled where it hashed inside the pack
//     loop or while Q K^T ran; a block's 64 scores a thread leave more room,
//     but the order is the one that spilled nowhere.
//   - O += P V: wgmma m64n64k16 with P from registers (the m64n128
//     accumulator's fragment, packed to bf16 pairs, is the A operand of its
//     k16 slices) and V from shared memory read MN-major (transposed), so V
//     needs no transpose; O is 32 fp32 registers a thread.
//   - Head dim D = 32 (vlmo_debug; its 1024^2 request streams BH = 24
//     heads of N = 4,097): the tiles hold 64-byte rows in the 64-byte
//     swizzle, Q K^T takes two k16 steps, P V is m64n32 over V read
//     MN-major (`desc_rows<32>`, 16 keys 1,024 bytes), O 16 registers, and
//     the ring and Q slots take half the shared memory; the loop is D =
//     64's.
//   - Ping-pong (PINGPONG): each warpgroup issues block j - 1's P V and
//     block j's Q K^T together in one turn, then runs block j's softmax on
//     the ALUs while the other warpgroup takes its turn on the tensor
//     cores; two named barriers pass the turn (warpgroup 0 first). A
//     warpgroup waits for its block's load before it takes its turn, never
//     holding the turn on the ring, which needs NS >= 2 (with one stage the
//     load of block j would wait for the other warpgroup's release of
//     block j - 1, which waits for this turn). Without the turns both
//     warpgroups ran their softmax at once and left the tensor cores idle
//     (0.1205 ms at BH = 384, N = 512 for row 1; SDPA 0.1094).
//   - Precision of p: with HILO p is split into hi + lo bf16 parts and P V
//     runs twice, which keeps 16 mantissa bits of p (v is bf16, exact); the
//     output then stays within one bf16 ulp of the fp32 plain version. A
//     single bf16 p halves the P V products (a variant in
//     scripts/torch_kernel_variants.json measures both).
//   - Finish: O / l, stored as bf16 for rows < N; with LSE, lse = m ln 2 +
//     log(l) in fp32.
// Left for later: overlap of a block's softmax with the same warpgroup's
// next Q K^T (two score tiles in registers, which the hi + lo p leaves no
// room for), and a TMA store of the output.

#include <cuda_bf16.h>
#include <math.h>

#include "dropout_hash.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace emm::sm90;

constexpr int BQ = 128;      // query rows per work item: two warpgroups of 64
constexpr int BK = 128;      // keys per block
constexpr int NS = 3;        // ring stages (K, V and bias of one block each)
constexpr int QS = 2;        // Q slots: the next item's Q loads during this one
constexpr bool HILO = true;  // p as hi + lo bf16 parts
constexpr bool PINGPONG = true;  // the warpgroups' products in turns
// the shared-memory layout at head dim D (64, or 32: 64-byte rows in the
// 64-byte swizzle, every tile half as large)
template <int D>
struct Cfg {
  static constexpr int TILE = BK * D * 2;  // 16 KB at D = 64: one K or V block, or Q
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + QS * TILE;
  static constexpr int V_OFF = K_OFF + NS * TILE;
  static constexpr int BIAS_OFF = V_OFF + NS * TILE;  // NS x BK fp32
  static constexpr int BAR_OFF = BIAS_OFF + NS * BK * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * QS + 2 * NS) + 1024;  // + alignment slack
  static_assert(BQ == 2 * 64 && TILE == BQ * D * 2, "Q shares the K/V box");
  static_assert(SMEM <= 232448, "shared memory");
};
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED = -1e30f;  // the key-padding bias of a masked key

// 2^x on the MUFU unit, subnormal results flushed to 0: a p = 2^(s - m) below
// 2^-126 of the row's largest term adds nothing that an fp32 sum keeps, and
// the non-flushing exp2f costs 4-6% here (variant attn_stream_exp2f); -inf
// gives 0
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A running ring position: the slot and the parity of its current use.
template <int SLOTS>
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == SLOTS) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// q, k, v through their (D, n, bh) maps in (D, 128, 1) boxes; bias (bh /
// heads, n) fp32; out (bh, n, D) bf16; with LSE, lse (bh, n) fp32. Work
// item i is query tile i % tiles of head i / tiles; CTA c takes items c,
// c + gridDim.x, ... scale_log2 = scale * log2(e). With DROP, seed is one
// int32 on the device; a (row, key) is kept where its hash bits are >=
// thr, then scaled by drop_scale; row_index (null or bh / heads int32)
// gives each row's global index and head0 / heads_total the heads' offset
// and total, which key its heads' masks (`dropout_head`).
template <int D, bool LSE, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
attn_stream_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        float* __restrict__ lse, int n, int heads, int tiles, int items,
                        float scale_log2, const int32_t* __restrict__ seed,
                        const int32_t* __restrict__ row_index, int heads_total,
                        int head0, uint32_t thr, float drop_scale) {
  using C = Cfg<D>;
  constexpr int TILE = C::TILE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* sbias = reinterpret_cast<float*>(smem_raw + (base - raw) + C::BIAS_OFF);
  const uint32_t qfull0 = base + C::BAR_OFF, qempty0 = qfull0 + 8 * QS;
  const uint32_t full0 = qempty0 + 8 * QS, empty0 = full0 + 8 * NS;
  const int blocks = (n + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < QS; ++s) {
      mbar_init(qfull0 + 8 * s, 1);   // the producer's lane 0, with the bytes
      mbar_init(qempty0 + 8 * s, 8);  // each consumer warp, once its item is done
    }
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
    Ring<QS> qr;
    Ring<NS> kr;
    for (int item = blockIdx.x; item < items; item += gridDim.x, qr.next()) {
      const int bh = item / tiles, q0 = (item % tiles) * BQ;
      mbar_wait(qempty0 + 8 * qr.slot, qr.phase ^ 1u);
      if (lane == 0) {
        mbar_arrive_expect_tx(qfull0 + 8 * qr.slot, TILE);
        tma_load_3d(base + C::Q_OFF + qr.slot * TILE, &mq, qfull0 + 8 * qr.slot, 0, q0, bh);
      }
      const float* kb = bias + (size_t)(bh / heads) * n;
      for (int j = 0; j < blocks; ++j, kr.next()) {
        const int s = kr.slot;
        mbar_wait(empty0 + 8 * s, kr.phase ^ 1u);
        for (int i = lane; i < BK; i += 32) {
          const int key = j * BK + i;
          sbias[s * BK + i] = key < n ? kb[key] * LOG2E : -INFINITY;
        }
        const uint32_t full = full0 + 8 * s;
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 2 * TILE);
          tma_load_3d(base + C::K_OFF + s * TILE, &mk, full, 0, j * BK, bh);
          tma_load_3d(base + C::V_OFF + s * TILE, &mv, full, 0, j * BK, bh);
        } else {
          mbar_arrive(full);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows q0 + 64 w .. of every item
  setmaxnreg_inc<240>();
  const int w = wg, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, qd = lane % 4;
  const int32_t sd = DROP ? *seed : 0;
  // ping-pong: warpgroup w issues its products after named barrier 1 + w
  // and then lets the other issue; warpgroup 1 lets warpgroup 0 go first
  // (and warpgroup 0 takes that last turn back at the end)
  if (PINGPONG && w == 1) named_bar_arrive(1, 256);
  Ring<QS> qr;
  Ring<NS> kr;
  for (int item = blockIdx.x; item < items; item += gridDim.x, qr.next()) {
    const int bh = item / tiles;
    const uint32_t sq = base + C::Q_OFF + qr.slot * TILE + w * (TILE / 2);
    // rows 16 warp + g (h = 0) and + 8 (h = 1) of this warpgroup's 64
    const int row0 = (item % tiles) * BQ + 64 * w + 16 * warp + g;
    emm::DropKeys key{0u, 0u};
    if constexpr (DROP)
      key = emm::dropout_keys(sd, emm::dropout_head(row_index, bh, heads, heads_total, head0));
    // DROP: block j's keep bits, bit i % 32 of kb[i / 32] for score
    // register i (row row0 + 8 ((i >> 1) & 1), key 8 (i >> 2) + 2 qd + (i &
    // 1) of the block), hashed while the scores are not live (before the
    // products that make them); the fence keeps the compiler from sinking
    // the hashes into the pack loop
    uint32_t kb[2] = {0u, 0u};
    auto hash = [&](int j) {
      if constexpr (DROP) {
        kb[0] = kb[1] = 0u;
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 4 * jj + r;
            const uint32_t bits = emm::dropout_bits(key, row0 + 8 * (r >> 1),
                                                    j * BK + 8 * jj + 2 * qd + (r & 1));
            kb[i / 32] |= static_cast<uint32_t>(bits >= thr) << (i % 32);
          }
        asm volatile("" : "+r"(kb[0]), "+r"(kb[1]));
      }
    };
    float o[D / 2], sc[64];
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {MASKED * LOG2E, MASKED * LOG2E}, l[2] = {0.f, 0.f};
    mbar_wait(qfull0 + 8 * qr.slot, qr.phase);

    // The products of block j run in one turn with the P V of block j - 1:
    // turn j issues P V (j - 1) (none at j = 0) and Q K^T (j) (none at j =
    // blocks), then the softmax of block j runs while the other warpgroup
    // takes its turn.
    Ring<NS> prev = kr;  // the stage of block j - 1
    for (int j = 0; j <= blocks; ++j) {
      const bool qk = j < blocks;
      if (qk) {
        hash(j);
        mbar_wait(full0 + 8 * kr.slot, kr.phase);
      }
      const uint32_t sk = base + C::K_OFF + kr.slot * TILE;
      const uint32_t sv = base + C::V_OFF + prev.slot * TILE;
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      if (PINGPONG) named_bar_sync(1 + w, 256);
      fence_regs(sc);
      fence_regs(o);
      wgmma_fence();
      if (j > 0) {  // O (64 x D) += P V, V read MN-major: 16 keys are 32 D bytes
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t dv = desc_rows<D>(sv + kk * 32 * D);
          wgmma_rs_mn<D>(o, hi[kk], dv);
          if (HILO) wgmma_rs_mn<D>(o, lo[kk], dv);
        }
      }
      if (qk) {  // S (64 x 128) = Q K^T
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss_n128(sc, desc_rows<D>(sq + 32 * k), desc_rows<D>(sk + 32 * k));
      }
      wgmma_commit();
      if (PINGPONG) named_bar_arrive(1 + (1 - w), 256);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(o);
      if (j > 0) {  // block j - 1 is read
        if (lane == 0) mbar_arrive(empty0 + 8 * prev.slot);
        prev.next();
      }
      if (!qk) break;
      kr.next();

      // scores in log2 units, the block's row max
      const float* sb = sbias + prev.slot * BK;
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
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // p, packed as the A fragments of the 8 k16 slices of P V
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // register r of slice kk: key tile 2 kk + (r >> 1), row half r & 1
          const int jj = 2 * kk + (r >> 1), h = r & 1;
          float p0 = ex2_ftz(sc[4 * jj + 2 * h] - m[h]);
          float p1 = ex2_ftz(sc[4 * jj + 2 * h + 1] - m[h]);
          l[h] += p0 + p1;
          if constexpr (DROP) {  // after the clean row sum: only P V sees the mask
            const int i = 4 * jj + 2 * h;
            p0 = (kb[i / 32] >> (i % 32) & 1u) ? p0 * drop_scale : 0.f;
            p1 = (kb[i / 32] >> (i % 32 + 1) & 1u) ? p1 * drop_scale : 0.f;
          }
          const __nv_bfloat162 hv = __floats2bfloat162_rn(p0, p1);
          hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hv);
          if (HILO) {
            const float2 hf = __bfloat1622float2(hv);
            lo[kk][r] = pack_bf16(p0 - hf.x, p1 - hf.y);
          }
        }
      }
    }
    // every product that reads this item's Q has completed
    if (lane == 0) mbar_arrive(qempty0 + 8 * qr.slot);

    // finish: O / l (and lse) for rows < n
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + 8 * h;
      if (row >= n) continue;
      bf16* dst = out + ((size_t)bh * n + row) * D;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj + 2 * qd) =
            __floats2bfloat162_rn(o[4 * jj + 2 * h] / l[h], o[4 * jj + 2 * h + 1] / l[h]);
      if (LSE && qd == 0) lse[(size_t)bh * n + row] = m[h] * LN2 + logf(l[h]);
    }
  }
  if (PINGPONG && w == 0) named_bar_sync(1, 256);
}

template <int D, bool LSE, bool DROP>
int run(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, const void* bias,
           void* out, void* lse, int heads, int n, int tiles, int items, int grid, float scale,
           const void* seed, const void* row_index, int heads_total, int head0, uint32_t thr,
           float drop_scale, void* stream) {
  constexpr int SMEM = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(attn_stream_sm90_kernel<D, LSE, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_stream_sm90_kernel<D, LSE, DROP>
      <<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
          q, k, v, static_cast<const float*>(bias), static_cast<bf16*>(out),
          static_cast<float*>(lse), n, heads, tiles, items, scale * LOG2E,
          static_cast<const int32_t*>(seed), static_cast<const int32_t*>(row_index),
          heads_total, head0, thr, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

// run<d, LSE, DROP> for the head dim d, 64 or 32
template <bool LSE, bool DROP>
int launch(int d, const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
           const void* bias, void* out, void* lse, int heads, int n, int tiles, int items,
           int grid, float scale, const void* seed, const void* row_index, int heads_total,
           int head0, uint32_t thr, float drop_scale, void* stream) {
  return d == 64 ? run<64, LSE, DROP>(q, k, v, bias, out, lse, heads, n, tiles, items, grid,
                                      scale, seed, row_index, heads_total, head0, thr,
                                      drop_scale, stream)
                 : run<32, LSE, DROP>(q, k, v, bias, out, lse, heads, n, tiles, items, grid,
                                      scale, seed, row_index, heads_total, head0, thr,
                                      drop_scale, stream);
}

}  // namespace

// Encodes into `out` (128 bytes, host memory) the bf16 tensor map at `base`
// with the given extents: `rank` dims innermost first, the byte strides of
// dims 1.., the box (D, 128, 1), D 64 or 32 (the 64-byte swizzle). Returns
// a cudaError_t.
extern "C" int flash_attention_long_sm90_encode(void* out, const void* base, int rank,
                                                const uint64_t* dims,
                                                const uint64_t* strides_bytes,
                                                const uint32_t* box) {
  if (rank != 3 || dims[0] != box[0] || box[1] != BK || box[2] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return emm_encode_head_map(out, base, rank, dims, strides_bytes, box);
}

// The dynamic shared memory the kernel takes at head dim `d`, -1 for another.
extern "C" int flash_attention_long_sm90_smem(int d) {
  return d == 64 ? Cfg<64>::SMEM : d == 32 ? Cfg<32>::SMEM : -1;
}

// The one entry of rows 5, 1 and 3. mq, mk, mv: the maps of q, k, v (bh, n,
// d) bf16 (from `flash_attention_long_sm90_encode`, host memory), d the
// head dim, 64 or 32; bias (bh / heads, n) fp32; out (bh, n, d) bf16;
// `tiles` = ceil(n / 128) query tiles a head; `grid`: persistent CTAs, 1..bh
// * tiles. lse: null for row 5 (the output only), else (bh, n) fp32 (rows 1
// and 3). seed: null without dropout; for row 3 one int32 on the device, a
// (row, key) kept where its hash bits are >= `threshold` (min(int(rate *
// 2^32), 2^32 - 1)) and then scaled by `drop_scale`; it needs an lse.
// row_index: null (each row's own index), or (bh / heads) int32 on the
// device, each row's index in the global batch, which keys its heads' masks
// (row 3 only). heads_total, head0: the call holds heads head0 .. head0 +
// heads - 1 of each row's heads_total (tensor parallelism), which key the
// masks by their global index; heads and 0 otherwise. Launches on
// `stream`; returns the launch's cudaError_t.
extern "C" int flash_attention_long_sm90(const void* mq, const void* mk, const void* mv,
                                         const void* bias, const void* seed,
                                         const void* row_index, void* out, void* lse, int bh,
                                         int heads, int heads_total, int head0, int n,
                                         int tiles, int grid, float scale, unsigned threshold,
                                         float drop_scale, int d, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || n <= 0 || tiles != (n + BQ - 1) / BQ ||
      head0 < 0 || head0 + heads > heads_total || (d != 32 && d != 64) ||
      (long long)bh * tiles > 0x7fffffff || grid <= 0 || grid > bh * tiles ||
      (seed != nullptr && lse == nullptr) || (row_index != nullptr && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q, k, v;
  memcpy(&q, mq, sizeof(q));
  memcpy(&k, mk, sizeof(k));
  memcpy(&v, mv, sizeof(v));
  const int items = bh * tiles;
  if (lse == nullptr)
    return launch<false, false>(d, q, k, v, bias, out, lse, heads, n, tiles, items, grid, scale,
                                seed, nullptr, heads_total, head0, threshold, drop_scale,
                                stream);
  if (seed == nullptr)
    return launch<true, false>(d, q, k, v, bias, out, lse, heads, n, tiles, items, grid, scale,
                               seed, nullptr, heads_total, head0, threshold, drop_scale,
                               stream);
  return launch<true, true>(d, q, k, v, bias, out, lse, heads, n, tiles, items, grid, scale,
                            seed, row_index, heads_total, head0, threshold, drop_scale, stream);
}
