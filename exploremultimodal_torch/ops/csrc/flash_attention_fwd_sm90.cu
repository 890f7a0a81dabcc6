// Short-sequence flash-attention forward for Hopper (sm_90a) on wgmma and
// TMA, for N <= 256, with and without attention dropout (DROP).
//
// Replaces two Pallas kernels of exploremultimodal_tpu/ops/flash_attention.py
// at every length the VLMo paths give them (text 40, image 197, fused 237
// tokens): `_attn_kernel` (:152, launched by `_fwd_call` :283) and, with
// DROP, `_attn_drop_kernel` (:209, launched by `_fwd_drop_call` :323).
// Longer rows (256 < N <= 4096, or 512 with dropout) take the streamed
// kernel of flash_attention_long_sm90.cu. Same function: for each (batch*head,
// query row)
//   s   = (q . k^T) * scale + key_bias           fp32
//   m   = max(s) over all N keys;  p = exp(s - m);  l = sum(p)
//   out = ((keep o p) . v) / l                   fp32 sum, stored as bf16
//   lse = m + log(l)                             fp32, read by the backward
// with bf16 q, k, v (head dim D: 64, every preset's but vlmo_debug, or
// vlmo_debug's 32) and an fp32 (B, N) key bias. keep is 1
// without DROP; with it, the hash mask of dropout_hash.cuh times 1 / (1 -
// rate), applied after the row sum, so l and lse stay clean and the
// backward rebuilds the clean p from lse.
//
// What bounds it on an H100: memory. It does 4 N^2 D flops per head against
// 8 N D bytes of q, k, v and out, N / 2 flops per byte: about 20 to 120 at
// N = 40 to 237, below the ~295 where the tensor cores become the limit.
// The design reads each head's q, k and v once and keeps the (N, N) scores
// in registers.
//
// Design:
//   - A head's whole K and V fit in shared memory at N <= 256: the kernel
//     is instantiated for key widths NT = N rounded up to 16 (the wgmma N
//     of Q K^T and 16-key slices of P V: 48 at N = 40, 208 at 197, 240 at
//     237, so no more than 15 padded keys are computed) and head dims D =
//     64 and 32, and one slot holds a head's Q, K and V (3 x NTB x 2 D
//     bytes, NTB = NT rounded up to the 64-row TMA box, in the swizzle that
//     wgmma reads: 128-byte rows at D = 64, 64-byte rows in the 64-byte
//     swizzle at D = 32) and its key bias.
//   - D = 32 (vlmo_debug's 96 wide, 3 heads): Q K^T takes two k16 steps
//     over the 64-byte rows, P V runs at wgmma N = 32 over V read MN-major
//     through `desc_rows<32>` (16 keys are 1,024 bytes), O is 16 registers,
//     and a slot is half as large, so four heads are in flight at every
//     width. The products and the softmax keep D = 64's order.
//   - Persistent CTAs, one per SM or one per head where there are fewer
//     heads: CTA c takes heads c, c + grid, ... One producer warp loads the
//     next heads by TMA (boxes of 64 rows through a 3D map over (D, N, BH),
//     so a box stops at its head's N and TMA fills the rest with zeros)
//     into a ring of up to MAX_SLOTS slots with full/empty mbarriers, while
//     the consumers compute the current one. The bias row (4 N bytes apart,
//     not 16-byte aligned at odd N, so no tensor map) is read by the
//     producer warp with plain loads, times log2(e), -inf past N.
//   - Two consumer warpgroups take a head's 64-row query tiles in turn
//     (tile u of the CTA's sequence goes to warpgroup u % 2), so at N = 40
//     they take alternate heads and at N = 197 two tiles of each.
//   - S = Q K^T: wgmma m64nNTk16 with both operands in shared memory, four
//     k steps over D; NT / 2 fp32 registers a thread.
//   - One pass with the full-row max, as the TPU kernel: every key is in
//     the accumulator, so there is no running max and no rescaling; p =
//     exp2(s' - m') in log2 units (scale * log2(e) folded in), lse = m' ln 2
//     + log(l). Keys past N score -inf and add exactly 0; a row whose real
//     keys are all masked (bias -1e30) averages them as the plain version.
//   - O = P V: wgmma m64n64k16 with P from registers (the score
//     accumulator's fragment packed to bf16 pairs is the A operand of its
//     k16 slices) and V read MN-major from shared memory, so V needs no
//     transpose. p is split into hi + lo bf16 parts and P V runs twice,
//     which keeps 16 mantissa bits of p (one bf16 p left the tolerance in
//     row 5).
//   - DROP: each consumer takes the head's hash keys and, before the score
//     registers are live, hashes its NT / 2 (row, key) pairs of the tile
//     into NT / 64 words of keep bits. After adding p to l and before the
//     hi + lo split, p becomes p * scale where its bit is set and 0 where
//     not. Hashing inside the pack loop instead (as a factor p * keep)
//     spilled at NT = 256, and so did the bits hashed while Q K^T runs
//     (NT = 192-256) or applied as the factor (NT = 256).
//   - The consumer walks its slots with a running slot and phase, not i %
//     SLOTS: the division by 3 slots at NT = 144-192 made ptxas spill at
//     NT = 192.
//   - Finish: O / l as bf16 and lse for rows < N, stored from registers.
// What holds it back (scripts/torch_kernel_variants.py on an H100, BH =
// 768): at N = 197 and 237 (0.062 and 0.075 ms, 2.7x the bound) the
// softmax on the ALUs (64 x NT exponentials and hi/lo packs a tile), which
// each warpgroup runs between its two products; without the next head's
// prefetch they take 0.085 / 0.094. At N = 40 (0.012 ms) a CTA's chain of
// short tiles; a fixed 256-key width takes 0.027 there, widths rounded to
// 64 instead of 16 0.069 at N = 197.
// Left for later: a TMA store of the output (the register stores write 16
// bytes per row segment), and ping-pong ordering of the two warpgroups.

#include <cuda_bf16.h>
#include <math.h>

#include <utility>

#include "dropout_hash.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace emm::sm90;

constexpr int BOX_KEYS = 64;   // rows of q, k or v per TMA box
constexpr int MAX_SLOTS = 4;   // heads in flight per CTA
constexpr int THREADS = 384;   // two consumer warpgroups and a producer warpgroup
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory of the kernel at NT keys and head dim D: SLOTS slots of Q,
// K and V (rows of 2 D bytes), then the slots' bias rows, then a full and
// an empty barrier per slot
template <int NT, int D>
struct Cfg {
  static constexpr int NTB = (NT + BOX_KEYS - 1) / BOX_KEYS * BOX_KEYS;  // rows loaded
  static constexpr int TILE = NTB * D * 2;  // Q, K or V of one head
  static constexpr int SLOT = 3 * TILE;
  static constexpr int BIAS = NTB * 4;
  static constexpr int SLOTS_FIT = (SMEM_LIMIT - 1024 - 16 * MAX_SLOTS) / (SLOT + BIAS);
  static constexpr int SLOTS = SLOTS_FIT < MAX_SLOTS ? SLOTS_FIT : MAX_SLOTS;
  static constexpr int BIAS_OFF = SLOTS * SLOT;
  static constexpr int BAR_OFF = BIAS_OFF + SLOTS * BIAS;
  static constexpr int SMEM = BAR_OFF + 16 * SLOTS + 1024;  // + alignment slack
  static_assert(NT % 16 == 0 && NT <= 256, "a wgmma N of whole 16-key slices");
  static_assert(SLOTS >= 1 && SMEM <= SMEM_LIMIT, "shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The dropout of one head: its hash keys, the uint32 threshold and the
// inverted-dropout factor
struct Drop {
  emm::DropKeys key;
  uint32_t thr;
  float scale;
};

// One warpgroup's 64 query rows (from row0) of head bh: Q at sq (64 rows),
// K at sk and V at sv (NT rows each), the bias row in log2 units at sb.
template <int NT, int D, bool DROP>
__device__ __forceinline__ void attend(uint32_t sq, uint32_t sk, uint32_t sv,
                                       const float* sb, bf16* __restrict__ out,
                                       float* __restrict__ lse, int bh, int n, int row0,
                                       float scale_log2, int warp, int g, int qd,
                                       const Drop& drop) {
  // DROP: the tile's keep bits, bit i % 32 of kb[i / 32] for score register
  // i, hashed before the scores take their registers. The fence keeps the
  // compiler from sinking the hashes into the pack loop below, where the
  // scores, p and its hi/lo parts already fill the registers.
  constexpr int KB = DROP ? (NT + 63) / 64 : 1;
  uint32_t kb[KB];
  if constexpr (DROP) {
#pragma unroll
    for (int w = 0; w < KB; ++w) kb[w] = 0u;
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * jj + r, row = row0 + 16 * warp + g + 8 * (r >> 1);
        const uint32_t bits = emm::dropout_bits(drop.key, row, 8 * jj + 2 * qd + (r & 1));
        kb[i / 32] |= static_cast<uint32_t>(bits >= drop.thr) << (i % 32);
      }
#pragma unroll
    for (int w = 0; w < KB; ++w) asm volatile("" : "+r"(kb[w]));
  }

  // S (64 x NT) = Q K^T
  float sc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    wgmma_ss_bf16<NT>(sc, desc_rows<D>(sq + 32 * k), desc_rows<D>(sk + 32 * k));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);

  // scores in log2 units and the full-row max; register 4 jj + 2 h + e is
  // row 16 warp + g + 8 h, key 8 jj + 2 qd + e
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jj = 0; jj < NT / 8; ++jj) {
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // a row lives on the 4 lanes of a quad
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }

  // p, packed as the A fragments of the NT / 16 k16 slices of P V
  float l[2] = {0.f, 0.f};
  uint32_t hi[NT / 16][4], lo[NT / 16][4];
#pragma unroll
  for (int kk = 0; kk < NT / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // register r of slice kk: key tile 2 kk + (r >> 1), row half r & 1
      const int jj = 2 * kk + (r >> 1), h = r & 1;
      float p0 = exp2f(sc[4 * jj + 2 * h] - mx[h]);
      float p1 = exp2f(sc[4 * jj + 2 * h + 1] - mx[h]);
      l[h] += p0 + p1;
      if constexpr (DROP) {  // after the clean row sum: only P V sees the mask;
        // p is computed either way, so the select has no work to skip
        const int i = 4 * jj + 2 * h;
        p0 = (kb[i / 32] >> (i % 32) & 1u) ? p0 * drop.scale : 0.f;
        p1 = (kb[i / 32] >> (i % 32 + 1) & 1u) ? p1 * drop.scale : 0.f;
      }
      const __nv_bfloat162 hv = __floats2bfloat162_rn(p0, p1);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hv);
      const float2 hf = __bfloat1622float2(hv);
      lo[kk][r] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }
  }

  // O (64 x D) = P V, V read MN-major: 16 keys are 32 D bytes
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NT / 16; ++kk) {
    const uint64_t dv = desc_rows<D>(sv + kk * 32 * D);
    wgmma_rs_mn<D>(o, hi[kk], dv);
    wgmma_rs_mn<D>(o, lo[kk], dv);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row0 + 16 * warp + g + 8 * h;
    if (row >= n) continue;
    bf16* dst = out + ((size_t)bh * n + row) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj + 2 * qd) =
          __floats2bfloat162_rn(o[4 * jj + 2 * h] / l[h], o[4 * jj + 2 * h + 1] / l[h]);
    if (qd == 0) lse[(size_t)bh * n + row] = mx[h] * LN2 + logf(l[h]);
  }
}

// q, k, v through their (D, n, bh) maps in (D, 64, 1) boxes; bias (bh /
// heads, n) fp32; out (bh, n, D) bf16; lse (bh, n) fp32. scale_log2 =
// scale * log2(e). With DROP, seed is one int32 on the device; a (row, key)
// is kept where its hash bits are >= thr, then scaled by drop_scale.
template <int NT, int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse, int bh_total, int n,
                     int heads, float scale_log2, const int32_t* __restrict__ seed,
                     const int32_t* __restrict__ row_index, int heads_total, int head0,
                     uint32_t thr, float drop_scale) {
  using C = Cfg<NT, D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* sbias = reinterpret_cast<float*>(smem_raw + (base - raw) + C::BIAS_OFF);
  const uint32_t full0 = base + C::BAR_OFF, empty0 = full0 + 8 * C::SLOTS;
  const int tiles = (n + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
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
    int i = 0;
    for (int bh = blockIdx.x; bh < bh_total; bh += gridDim.x, ++i) {
      const int s = i % C::SLOTS;
      mbar_wait(empty0 + 8 * s, ((i / C::SLOTS) & 1) ^ 1);
      const float* kb = bias + (size_t)(bh / heads) * n;
      for (int j = lane; j < NT; j += 32)
        sbias[s * C::NTB + j] = j < n ? kb[j] * LOG2E : -INFINITY;
      const uint32_t full = full0 + 8 * s, dst = base + s * C::SLOT;
      if (lane == 0) {
        mbar_arrive_expect_tx(full, C::SLOT);
#pragma unroll
        for (int b = 0; b < C::NTB / BOX_KEYS; ++b) {
          const uint32_t off = b * BOX_KEYS * D * 2;
          tma_load_3d(dst + off, &mq, full, 0, BOX_KEYS * b, bh);
          tma_load_3d(dst + C::TILE + off, &mk, full, 0, BOX_KEYS * b, bh);
          tma_load_3d(dst + 2 * C::TILE + off, &mv, full, 0, BOX_KEYS * b, bh);
        }
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w takes the CTA's query tiles u with u % 2 == w
  setmaxnreg_inc<240>();
  const int w = wg, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, qd = lane % 4;
  const int32_t sd = DROP ? *seed : 0;
  Drop drop{{0u, 0u}, thr, drop_scale};
  int s = 0, u = 0;
  uint32_t phase = 0;
  for (int bh = blockIdx.x; bh < bh_total; bh += gridDim.x) {
    mbar_wait(full0 + 8 * s, phase);
    const uint32_t sq = base + s * C::SLOT;
    if constexpr (DROP)
      drop.key = emm::dropout_keys(sd, emm::dropout_head(row_index, bh, heads, heads_total, head0));
    for (int t = 0; t < tiles; ++t, ++u) {
      if ((u & 1) != w) continue;
      attend<NT, D, DROP>(sq + t * 64 * D * 2, sq + C::TILE, sq + 2 * C::TILE,
                          sbias + s * C::NTB, out, lse, bh, n, 64 * t, scale_log2, warp, g, qd,
                          drop);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (++s == C::SLOTS) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <int NT, int D, bool DROP>
int launch(const void* mq, const void* mk, const void* mv, const void* bias, void* out,
           void* lse, int bh, int heads, int n, int grid, float scale, const void* seed,
           const void* row_index, int heads_total, int head0, uint32_t thr, float drop_scale,
           void* stream) {
  CUtensorMap q, k, v;
  memcpy(&q, mq, sizeof(q));
  memcpy(&k, mk, sizeof(k));
  memcpy(&v, mv, sizeof(v));
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_sm90_kernel<NT, D, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<NT, D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_sm90_kernel<NT, D, DROP>
      <<<grid, THREADS, Cfg<NT, D>::SMEM, static_cast<cudaStream_t>(stream)>>>(
          q, k, v, static_cast<const float*>(bias), static_cast<bf16*>(out),
          static_cast<float*>(lse), bh, n, heads, scale * LOG2E,
          static_cast<const int32_t*>(seed), static_cast<const int32_t*>(row_index),
          heads_total, head0, thr, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

// fn(std::integral_constant<int, nt>()) for a key width nt = 16, 32, ...,
// 256; nothing for another nt
template <typename Fn, int... I>
void for_widths(int nt, Fn fn, std::integer_sequence<int, I...>) {
  ((nt == 16 * (I + 1) ? (fn(std::integral_constant<int, 16 * (I + 1)>()), 0) : 0), ...);
}

template <typename Fn>
void for_widths(int nt, Fn fn) {
  for_widths(nt, fn, std::make_integer_sequence<int, 16>());
}

template <int D, bool DROP>
int dispatch(const void* mq, const void* mk, const void* mv, const void* bias, void* out,
             void* lse, int bh, int heads, int n, int nt, int grid, float scale,
             const void* seed, const void* row_index, int heads_total, int head0, uint32_t thr,
             float drop_scale, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || n <= 0 || n > nt || grid <= 0 ||
      grid > bh || head0 < 0 || head0 + heads > heads_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const int key_width = nt;  // the instantiation that runs
  int rc = static_cast<int>(cudaErrorInvalidValue);
  for_widths(key_width, [&](auto w) {
    rc = launch<decltype(w)::value, D, DROP>(mq, mk, mv, bias, out, lse, bh, heads, n, grid,
                                             scale, seed, row_index, heads_total, head0, thr,
                                             drop_scale, stream);
  });
  return rc;
}

template <bool DROP>
int dispatch_d(int d, const void* mq, const void* mk, const void* mv, const void* bias,
               void* out, void* lse, int bh, int heads, int n, int nt, int grid, float scale,
               const void* seed, const void* row_index, int heads_total, int head0,
               uint32_t thr, float drop_scale, void* stream) {
  if (d == 64)
    return dispatch<64, DROP>(mq, mk, mv, bias, out, lse, bh, heads, n, nt, grid, scale, seed,
                              row_index, heads_total, head0, thr, drop_scale, stream);
  if (d == 32)
    return dispatch<32, DROP>(mq, mk, mv, bias, out, lse, bh, heads, n, nt, grid, scale, seed,
                              row_index, heads_total, head0, thr, drop_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Encodes into `out` (128 bytes, host memory) the bf16 tensor map of a
// (bh, n, D) q, k or v at `base`: `rank` 3 dims innermost first, the byte
// strides of dims 1.., the box (D, 64, 1), D 64 or 32 (the 64-byte
// swizzle). Returns a cudaError_t.
extern "C" int flash_attention_fwd_sm90_encode(void* out, const void* base, int rank,
                                               const uint64_t* dims,
                                               const uint64_t* strides_bytes,
                                               const uint32_t* box) {
  if (rank != 3 || dims[0] != box[0] || box[1] != BOX_KEYS || box[2] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return emm_encode_head_map(out, base, rank, dims, strides_bytes, box);
}

// The dynamic shared memory the kernel takes at `nt` keys and head dim `d`,
// -1 for an (nt, d) it is not built for.
extern "C" int flash_attention_fwd_sm90_smem(int nt, int d) {
  int smem = -1;
  for_widths(nt, [&](auto w) {
    if (d == 64) smem = Cfg<decltype(w)::value, 64>::SMEM;
    if (d == 32) smem = Cfg<decltype(w)::value, 32>::SMEM;
  });
  return smem;
}

// The one entry of rows 1 and 3. mq, mk, mv: the maps of q, k, v (bh, n,
// d) bf16 (from `flash_attention_fwd_sm90_encode`, host memory), d the
// head dim, 64 or 32; bias (bh / heads, n) fp32; out (bh, n, d) bf16; lse
// (bh, n) fp32; `nt`: the key width, n rounded up to 16 (n <= nt <=
// 256); `grid`: persistent CTAs, 1..bh. seed: null without dropout (row 1); for row 3 one int32 on the
// device, a (row, key) kept where its hash bits are >= `threshold`
// (min(int(rate * 2^32), 2^32 - 1)) and then scaled by `drop_scale`.
// row_index: null (each row's own index), or (bh / heads) int32 on the
// device, each row's index in the global batch, which keys its heads' masks
// (`dropout_head`); row 3 only. heads_total, head0: the call holds heads
// head0 .. head0 + heads - 1 of each row's heads_total (tensor parallelism),
// which key the masks by their global index; heads and 0 otherwise.
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int flash_attention_fwd_sm90(const void* mq, const void* mk, const void* mv,
                                        const void* bias, const void* seed,
                                        const void* row_index, void* out, void* lse, int bh,
                                        int heads, int heads_total, int head0, int n, int nt,
                                        int grid, float scale, unsigned threshold,
                                        float drop_scale, int d, void* stream) {
  return seed == nullptr
             ? dispatch_d<false>(d, mq, mk, mv, bias, out, lse, bh, heads, n, nt, grid, scale,
                                 nullptr, nullptr, heads_total, head0, 0u, 1.f, stream)
             : dispatch_d<true>(d, mq, mk, mv, bias, out, lse, bh, heads, n, nt, grid, scale,
                                seed, row_index, heads_total, head0, threshold, drop_scale,
                                stream);
}
