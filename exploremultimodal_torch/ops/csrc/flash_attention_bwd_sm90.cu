// Flash-attention backward, with and without in-kernel dropout (DROP), for
// Hopper (sm_90a) on wgmma and TMA, for N <= 512; bf16 in and out, fp32
// math.
//
// Replaces two Pallas kernels of exploremultimodal_tpu/ops/flash_attention.py
// at every length the fused backward takes (N <= 512; the VLMo training
// paths give text 40, image 197, fused 237 tokens): `_attn_bwd_kernel`
// (:170, launched by `_bwd_call` :395) and, with DROP, `_attn_drop_bwd_kernel`
// (:237, launched by `_bwd_drop_call` :362); one entry,
// `flash_attention_bwd_sm90`, takes either, by its seed. Same function: for each
// batch*head, with p = exp(s - lse) the clean probabilities rebuilt from the
// forward's lse and keep the forward's mask (dropout_hash.cuh, times 1 / (1
// - rate); 1 without DROP),
//   delta = rowsum(do o o)
//   dv    = (keep o p)^T . do
//   ds    = p o ((do . v^T) o keep - delta)
//   dq    = ds . k * scale,   dk = ds^T . q * scale
//
// What bounds it on an H100: the ALUs. The products are 10 N^2 D flops per
// head against 16 N D bytes (q, k, v, o, do in, dq, dk, dv out), N / 1.6
// flops per byte: below the ~295 where the tensor cores would be the
// limit, but every (row, key) element also costs an exp2 and a few FMAs
// on the CUDA cores and, with DROP, a three-round integer hash (the mask),
// about 20 operations at half the fp32 rate, which at N ~ 200 outweighs
// both the products and the bytes.
//
// Design: two persistent kernels, so that dq is reduced inside one CTA and
// the backward stays deterministic (no fp32 atomics), as the mma.sync one:
//   - DQ keeps queries as M: per 64-row query tile, S = Q K^T and dP = dO
//     V^T (wgmma, both operands in shared memory), p, the mask, ds, and dq
//     += ds K with ds from registers as the A operand and K read MN-major
//     (the descriptor's transpose, which bf16 wgmma allows). It computes
//     delta from the tile's O and dO and writes it for DKDV.
//   - DKDV keeps keys as M: per 64-key tile, S^T = K Q^T and dP^T = V dO^T,
//     then dv += (keep o p)^T dO and dk += ds^T Q, both from registers
//     against dO and Q read MN-major.
// A work unit is a head and a group of `tpg` of its 64-row M-side tiles
// (all of them, unless heads are fewer than SMs and smaller groups shorten
// the busiest CTA: at BH = 96, N = 512 four groups of two); CTA (x, y)
// takes group y of heads x, x + grid, ... (at most one CTA per SM). Each
// tile's dq, or dk and dv, is still summed in one CTA: no atomics, the
// same result for any grouping. The unit's B-side pair (K and V for DQ, Q
// and dO for DKDV, the head's whole N) comes by TMA into one of up to four
// head slots, with its column vectors (the key bias, or lse and delta)
// written beside it by the producer warp, so the next unit loads while
// this one computes; past about 320 keys only one slot fits (128 KB at N =
// 512) and the next unit's pair waits for the slot. The M-side operands
// come in 64-row tiles (Q, dO and O for DQ; K and V for DKDV) through a
// ring of up to four stages. Two consumer warpgroups take a CTA's tiles in
// turn. A parity wait cannot tell a stage's phase from the one two phases
// earlier, and with an odd stage count a stage's previous tile is the
// other warpgroup's: a warpgroup that ran ahead could pass its wait before
// its tile had landed. So each waits first, as the producer did before
// loading the tile, for the stage's previous tile to be released; that
// wait cannot alias (the tile before that one was its own, released), and
// it costs nothing the load did not already wait for. Boxes are 64 rows
// of a 3D map over (D, N, BH), so TMA stops at the head's N and fills the
// rest with zeros. Each tile walks the other side's N in 64-wide slabs and
// a last slab of NT % 64 (NT = N rounded up to 16), so no more than 15
// padded columns are computed (widths 48 / 208 / 240 at N = 40 / 197 /
// 237), and a slab's S and dP (64 + 64 fp32 registers) never sit beside
// another's; the slab loop does not depend on N, so N up to 512 takes the
// same four instantiations (by NT % 64) as N <= 256.
//
// What holds it back (scripts/torch_kernel_variants.py on an H100, the
// pretrain_mum step's shapes): the two kernels recompute S, dP, exp2 and
// the mask for every element, and the dq kernel takes 45-50% of the time;
// without the mask it runs 6-19% faster, with one head slot (no prefetch of
// the next head) 17-35% slower, with one bf16 part of p and ds 5-16% faster
// but out of tolerance. A single kernel (ds staged through shared memory
// for dq) was not built: at N = 240 its dq accumulator and ds tiles do not
// fit beside two head slots.
//
// Head dim: the kernels are instantiated at D = 64 and at vlmo_debug's D =
// 32. At 32 a row is 64 bytes in the 64-byte swizzle: S and dP take two k16
// steps, dq, dk and dv are m64n32 products over K, Q and dO read MN-major
// (`desc_rows<32>`, 16 rows 1,024 bytes), the delta pass reads one 16-byte
// chunk a lane, and boxes and head slots are half as large, so two head
// slots fit up to 512 keys.
//
// Precision: p and ds are split into hi + lo bf16 parts and each product
// with them runs twice, which keeps 16 mantissa bits (`HILO`; one bf16 p
// left the tolerance in rows 1 and 5). Ragged edges: keys past N take a
// -inf bias (p = 0), queries past N an lse of +inf and delta 0 (p = 0), so
// they add exactly 0; rows past N are not stored.

#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace emm::sm90;

constexpr int BOX = 64;                 // rows per TMA box, per tile and per slab
constexpr int MAX_SLOTS = 4;            // head slots and tile stages, each at most
constexpr int MAX_NT = 512;             // the widest key width (the fused backward's N)
constexpr int THREADS = 384;            // two consumer warpgroups and a producer warpgroup
constexpr int SMEM_LIMIT = 232448;
constexpr int BAR_BYTES = 8 * 4 * MAX_SLOTS;  // full and empty barriers of slots and stages
constexpr float LOG2E = 1.4426950408889634f;
constexpr bool HILO = true;             // p and ds as hi + lo bf16 parts
enum Role { DQ = 0, DKDV = 1 };

// one 64-row box of a (D, n, bh) map: rows of 2 D bytes, in the 128-byte
// swizzle at D = 64 and the 64-byte one at D = 32
__host__ __device__ constexpr int box_bytes(int d) { return BOX * d * 2; }

// Shared memory at key width nt and head dim d: `hs` head slots (the B-side
// pair, 2 x ntb rows), `ts` tile stages (3 or 2 boxes), the head slots'
// column vectors, the barriers, 1024 bytes of alignment slack. Tile stages
// first take what leaves room for two head slots (or, where that leaves
// fewer than two stages, one slot), then head slots what is left.
struct Layout {
  int ntb, head, vec, tile, ts, hs, tile_off, vec_off, bar_off, smem;
};

__host__ __device__ inline Layout layout(int nt, int role, int d) {
  Layout L;
  L.ntb = (nt + BOX - 1) / BOX * BOX;
  L.head = 2 * L.ntb * d * 2;
  L.vec = (role == DQ ? 1 : 2) * L.ntb * 4;
  L.tile = (role == DQ ? 3 : 2) * box_bytes(d);
  const int room = SMEM_LIMIT - 1024 - BAR_BYTES;
  int ts = (room - 2 * (L.head + L.vec)) / L.tile;
  if (ts < 2) ts = (room - (L.head + L.vec)) / L.tile;
  L.ts = ts < MAX_SLOTS ? ts : MAX_SLOTS;
  const int hs = (room - L.ts * L.tile) / (L.head + L.vec);
  L.hs = hs < MAX_SLOTS ? hs : MAX_SLOTS;
  L.tile_off = L.hs * L.head;
  L.vec_off = L.tile_off + L.ts * L.tile;
  L.bar_off = L.vec_off + L.hs * L.vec;
  L.smem = L.bar_off + BAR_BYTES + 1024;
  return L;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 as the bf16 pair `hi` and the pair of their residuals `lo`
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float2 f = __bfloat1622float2(h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

template <bool DROP>
__device__ __forceinline__ float keep(emm::DropKeys key, int row, int col, uint32_t thr,
                                      float drop_scale) {
  return DROP ? emm::dropout_keep(key, row, col, thr, drop_scale) : 1.f;
}

// Per-thread context: warp w of its warpgroup holds accumulator rows 16 w +
// g and + 8 (g = lane / 4); register 4 jj + 2 h + e of an m64nW accumulator
// is row 16 w + g + 8 h, column 8 jj + 2 qd + e (qd = lane % 4).
struct Ctx {
  int warp, g, qd;
  float sl2;  // scale * log2(e)
  emm::DropKeys key;
  uint32_t thr;
  float drop_scale;
};

// One DQ slab: columns (keys) s0 .. s0 + W of the tile at query row r0.
// sq, sdo: the tile's Q and dO; sk, sv: the head's K and V; sbias: the key
// bias in log2 units; lse2, dl: this thread's two rows' lse (log2 units)
// and delta. dq += ds K_slab. Each slab waits for its own products: left in
// flight across the next slab's accumulators, ptxas serialises every wgmma
// of the kernel (C7515), which cost 3-9%. Rows of D bf16 are 2 D bytes.
template <int W, int D, bool DROP>
__device__ __forceinline__ void dq_slab(float (&dq)[D / 2], uint32_t sq, uint32_t sdo,
                                        uint32_t sk, uint32_t sv, const float* sbias, int s0,
                                        int r0, const float (&lse2)[2], const float (&dl)[2],
                                        const Ctx& c) {
  float s[W / 2], dp[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    wgmma_ss_bf16<W>(s, desc_rows<D>(sq + 32 * k), desc_rows<D>(sk + s0 * 2 * D + 32 * k));
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    wgmma_ss_bf16<W>(dp, desc_rows<D>(sdo + 32 * k), desc_rows<D>(sv + s0 * 2 * D + 32 * k));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);

  // ds, packed as the A fragments of the W / 16 k16 slices of ds K
  uint32_t hi[W / 16][4], lo[W / 16][4];
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // register r of slice kk: key tile 2 kk + (r >> 1), row half r & 1
      const int jj = 2 * kk + (r >> 1), h = r & 1;
      const int row = r0 + 16 * c.warp + c.g + 8 * h, col = s0 + 8 * jj + 2 * c.qd;
      const float2 b = *reinterpret_cast<const float2*>(sbias + col);
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * h + e;
        const float p = exp2f(fmaf(s[i], c.sl2, e ? b.y : b.x) - lse2[h]);
        x[e] = p * (dp[i] * keep<DROP>(c.key, row, col + e, c.thr, c.drop_scale) - dl[h]);
      }
      if (HILO) {
        split(x[0], x[1], hi[kk][r], lo[kk][r]);
      } else {
        hi[kk][r] = pack_bf16(x[0], x[1]);
      }
    }
  }

  // dq (64 x D) += ds K_slab, K read MN-major: 16 keys are 32 D bytes
  fence_regs(dq);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint64_t dk = desc_rows<D>(sk + (s0 + 16 * kk) * 2 * D);
    wgmma_rs_mn<D>(dq, hi[kk], dk);
    if (HILO) wgmma_rs_mn<D>(dq, lo[kk], dk);
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// One DKDV slab: columns (queries) s0 .. s0 + W of the tile at key row k0.
// sk, sv: the tile's K and V; sq, sdo: the head's Q and dO; slse2, sdl: the
// head's lse (log2 units) and delta; kb2: this thread's two keys' bias in
// log2 units. dv += (keep o p)^T dO_slab, dk += ds^T Q_slab.
template <int W, int D, bool DROP>
__device__ __forceinline__ void dkdv_slab(float (&dk)[D / 2], float (&dv)[D / 2], uint32_t sk,
                                          uint32_t sv, uint32_t sq, uint32_t sdo,
                                          const float* slse2, const float* sdl, int s0, int k0,
                                          const float (&kb2)[2], const Ctx& c) {
  float s[W / 2], dp[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    wgmma_ss_bf16<W>(s, desc_rows<D>(sk + 32 * k), desc_rows<D>(sq + s0 * 2 * D + 32 * k));
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    wgmma_ss_bf16<W>(dp, desc_rows<D>(sv + 32 * k), desc_rows<D>(sdo + s0 * 2 * D + 32 * k));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);

  uint32_t phi[W / 16][4], plo[W / 16][4], dhi[W / 16][4], dlo[W / 16][4];
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jj = 2 * kk + (r >> 1), h = r & 1;
      const int key = k0 + 16 * c.warp + c.g + 8 * h, col = s0 + 8 * jj + 2 * c.qd;
      const float2 l = *reinterpret_cast<const float2*>(slse2 + col);
      const float2 dl = *reinterpret_cast<const float2*>(sdl + col);
      float pk[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * h + e;
        const float p = exp2f(fmaf(s[i], c.sl2, kb2[h]) - (e ? l.y : l.x));
        const float m = keep<DROP>(c.key, col + e, key, c.thr, c.drop_scale);
        pk[e] = p * m;
        ds[e] = p * (dp[i] * m - (e ? dl.y : dl.x));
      }
      if (HILO) {
        split(pk[0], pk[1], phi[kk][r], plo[kk][r]);
        split(ds[0], ds[1], dhi[kk][r], dlo[kk][r]);
      } else {
        phi[kk][r] = pack_bf16(pk[0], pk[1]);
        dhi[kk][r] = pack_bf16(ds[0], ds[1]);
      }
    }
  }

  fence_regs(dv);
  fence_regs(dk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint64_t ddo = desc_rows<D>(sdo + (s0 + 16 * kk) * 2 * D);
    const uint64_t dqq = desc_rows<D>(sq + (s0 + 16 * kk) * 2 * D);
    wgmma_rs_mn<D>(dv, phi[kk], ddo);
    if (HILO) wgmma_rs_mn<D>(dv, plo[kk], ddo);
    wgmma_rs_mn<D>(dk, dhi[kk], dqq);
    if (HILO) wgmma_rs_mn<D>(dk, dlo[kk], dqq);
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// rows 16 w + g (+ 8) of a 64 x D accumulator, times `mul`, to bf16 rows
// row0 + .. of dst (a head's (n, D)) below n
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 2],
                                           int row0, int n, float mul, const Ctx& c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * c.warp + c.g + 8 * h;
    if (row >= n) continue;
    bf16* p = dst + (size_t)row * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * jj + 2 * c.qd) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * h] * mul, acc[4 * jj + 2 * h + 1] * mul);
  }
}

// ROLE DQ: mx, my = K, V (the head's pair), ma, mb, mc = Q, dO, O (tiles);
// writes delta (bh, n) and dq (out0). ROLE DKDV: mx, my = Q, dO, ma, mb =
// K, V (mc unused); reads delta; writes dk (out0) and dv (out1). Every map
// is over (D, n, bh) in (D, 64, 1) boxes, D 64 or 32. bias (bh / heads, n) fp32; lse
// (bh, n) fp32; seed one int32 on the device (DROP) and row_index null or
// (bh / heads) int32, each row's global index, which with the heads' offset
// head0 and total heads_total keys its heads' masks (`dropout_head`). `nt`
// is n rounded up
// to 16, TAIL = nt % 64 the width of the last slab; with GROUPS a work unit
// is a head and `tpg` of its 64-row tiles (group blockIdx.y), else a whole
// head (the loop of every shape whose heads fill the card: with t0 and t1
// taken at run time it ran 2-6% slower on the pretrain_mum step's shapes,
// variant `attn_bwd_no_fork` of scripts/torch_kernel_variants.json).
template <int ROLE, int TAIL, int D, bool DROP, bool GROUPS>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap my,
                     const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap mb,
                     const __grid_constant__ CUtensorMap mc, const float* __restrict__ bias,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     const int32_t* __restrict__ seed, const int32_t* __restrict__ row_index,
                     bf16* __restrict__ out0, bf16* __restrict__ out1, int bh_total, int n,
                     int nt, int heads, int heads_total, int head0, int tpg, float scale,
                     uint32_t thr, float drop_scale) {
  const Layout L = layout(nt, ROLE, D);
  constexpr int BOX_BYTES = box_bytes(D);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* svec = reinterpret_cast<float*>(smem + L.vec_off);
  const int vstride = L.vec / 4;  // floats per head slot's vectors
  const uint32_t hfull0 = base + L.bar_off, hempty0 = hfull0 + 8 * MAX_SLOTS;
  const uint32_t tfull0 = hempty0 + 8 * MAX_SLOTS, tempty0 = tfull0 + 8 * MAX_SLOTS;
  const int tiles = (n + BOX - 1) / BOX;
  const int t0 = GROUPS ? blockIdx.y * tpg : 0;  // this CTA's tiles of a head
  const int t1 = GROUPS ? min(tiles, t0 + tpg) : tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L.hs; ++s) {
      mbar_init(hfull0 + 8 * s, 32);  // the producer warp's lanes (one with the bytes)
      mbar_init(hempty0 + 8 * s, 8);  // each consumer warp, once done with the head
    }
    for (int s = 0; s < L.ts; ++s) {
      mbar_init(tfull0 + 8 * s, 1);
      mbar_init(tempty0 + 8 * s, 4);  // each warp of the consuming warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == 2) {
    // ---- producer: warp 8 writes the column vectors; lane 0 starts every TMA
    setmaxnreg_dec<24>();
    if (threadIdx.x / 32 != 8) return;
    int i = 0, u = 0;
    for (int bh = blockIdx.x; bh < bh_total; bh += gridDim.x, ++i) {
      const int s = i % L.hs;
      mbar_wait(hempty0 + 8 * s, ((i / L.hs) & 1) ^ 1);
      float* v = svec + s * vstride;
      if (ROLE == DQ) {  // key bias in log2 units, -inf past n
        const float* kb = bias + (size_t)(bh / heads) * n;
        for (int j = lane; j < nt; j += 32) v[j] = j < n ? kb[j] * LOG2E : -INFINITY;
      } else {  // lse in log2 units (+inf past n) and delta (0 past n)
        const float* l = lse + (size_t)bh * n;
        const float* dl = delta + (size_t)bh * n;
        for (int j = lane; j < nt; j += 32) {
          v[j] = j < n ? l[j] * LOG2E : INFINITY;
          v[L.ntb + j] = j < n ? dl[j] : 0.f;
        }
      }
      const uint32_t hfull = hfull0 + 8 * s;
      if (lane == 0) {
        mbar_arrive_expect_tx(hfull, L.head);
        const uint32_t dst = base + s * L.head;
        for (int b = 0; b < L.ntb / BOX; ++b) {
          tma_load_3d(dst + b * BOX_BYTES, &mx, hfull, 0, BOX * b, bh);
          tma_load_3d(dst + L.head / 2 + b * BOX_BYTES, &my, hfull, 0, BOX * b, bh);
        }
        for (int t = t0; t < t1; ++t, ++u) {
          const int st = u % L.ts;
          mbar_wait(tempty0 + 8 * st, ((u / L.ts) & 1) ^ 1);
          const uint32_t tfull = tfull0 + 8 * st, tile = base + L.tile_off + st * L.tile;
          mbar_arrive_expect_tx(tfull, L.tile);
          tma_load_3d(tile, &ma, tfull, 0, BOX * t, bh);
          tma_load_3d(tile + BOX_BYTES, &mb, tfull, 0, BOX * t, bh);
          if (ROLE == DQ) tma_load_3d(tile + 2 * BOX_BYTES, &mc, tfull, 0, BOX * t, bh);
        }
      } else {
        mbar_arrive(hfull);
      }
      __syncwarp();
    }
    return;
  }

  // ---- consumers: warpgroup w takes the CTA's tiles u with u % 2 == w
  setmaxnreg_inc<240>();
  const int w = wg;
  Ctx c;
  c.warp = (threadIdx.x / 32) % 4;
  c.g = lane / 4;
  c.qd = lane % 4;
  c.sl2 = scale * LOG2E;
  c.thr = thr;
  c.drop_scale = drop_scale;
  const int32_t sd = DROP ? *seed : 0;
  constexpr int FULL_W = BOX;
  const int full = nt / BOX;  // 64-wide slabs before the TAIL one
  int i = 0, u = 0;
  for (int bh = blockIdx.x; bh < bh_total; bh += gridDim.x, ++i) {
    const int s = i % L.hs;
    mbar_wait(hfull0 + 8 * s, (i / L.hs) & 1);
    const uint32_t sx = base + s * L.head, sy = sx + L.head / 2;
    const float* v = svec + s * vstride;
    c.key = DROP ? emm::dropout_keys(
                       sd, emm::dropout_head(row_index, bh, heads, heads_total, head0))
                 : emm::DropKeys{0u, 0u};
    const size_t hbase = (size_t)bh * n;
    for (int t = t0; t < t1; ++t, ++u) {
      if ((u & 1) != w) continue;
      const int st = u % L.ts;
      // tile u - L.ts released: its load is complete, so this parity names
      // tile u's own phase (see the header)
      mbar_wait(tempty0 + 8 * st, ((u / L.ts) & 1) ^ 1);
      mbar_wait(tfull0 + 8 * st, (u / L.ts) & 1);
      const uint32_t ta = base + L.tile_off + st * L.tile, tb = ta + BOX_BYTES;
      const int r0 = BOX * t;
      float acc0[D / 2], acc1[D / 2];
#pragma unroll
      for (int k = 0; k < D / 2; ++k) acc0[k] = acc1[k] = 0.f;
      if constexpr (ROLE == DQ) {
        // delta of this thread's rows from the tile's dO and O: each lane
        // of a quad takes D / 32 16-byte chunks of a row, in the swizzle
        const unsigned char* tdo = smem + (tb - base);
        const unsigned char* to = tdo + BOX_BYTES;
        float lse2[2], dl[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = 16 * c.warp + c.g + 8 * h, row = r0 + lr;
          float d = 0.f;
#pragma unroll
          for (int k = 0; k < D / 32; ++k) {
            const int off = swizzled_chunk<D>(lr, D / 32 * c.qd + k);
            const uint4 a = *reinterpret_cast<const uint4*>(tdo + off);
            const uint4 b = *reinterpret_cast<const uint4*>(to + off);
            const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
            const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 fa = __bfloat1622float2(a2[e]), fb = __bfloat1622float2(b2[e]);
              d = fmaf(fa.x, fb.x, d);
              d = fmaf(fa.y, fb.y, d);
            }
          }
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          const bool real = row < n;
          dl[h] = real ? d : 0.f;
          lse2[h] = real ? lse[hbase + row] * LOG2E : INFINITY;
          if (real && c.qd == 0) delta[hbase + row] = d;
        }
#pragma unroll 1
        for (int sb = 0; sb < full; ++sb)
          dq_slab<FULL_W, D, DROP>(acc0, ta, tb, sx, sy, v, FULL_W * sb, r0, lse2, dl, c);
        if constexpr (TAIL > 0)
          dq_slab<TAIL, D, DROP>(acc0, ta, tb, sx, sy, v, FULL_W * full, r0, lse2, dl, c);
      } else {
        const float* kb = bias + (size_t)(bh / heads) * n;
        float kb2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = r0 + 16 * c.warp + c.g + 8 * h;
          kb2[h] = key < n ? kb[key] * LOG2E : -INFINITY;
        }
#pragma unroll 1
        for (int sb = 0; sb < full; ++sb)
          dkdv_slab<FULL_W, D, DROP>(acc0, acc1, ta, tb, sx, sy, v, v + L.ntb, FULL_W * sb,
                                     r0, kb2, c);
        if constexpr (TAIL > 0)
          dkdv_slab<TAIL, D, DROP>(acc0, acc1, ta, tb, sx, sy, v, v + L.ntb, FULL_W * full,
                                   r0, kb2, c);
      }
      fence_regs(acc0);
      if constexpr (ROLE == DKDV) fence_regs(acc1);
      __syncwarp();
      if (lane == 0) mbar_arrive(tempty0 + 8 * st);  // the tile's operands are read
      store_rows<D>(out0 + hbase * D, acc0, r0, n, scale, c);
      if constexpr (ROLE == DKDV) store_rows<D>(out1 + hbase * D, acc1, r0, n, 1.f, c);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(hempty0 + 8 * s);
  }
}

template <int ROLE, int TAIL, int D, bool DROP, bool GROUPS>
int launch_one(const CUtensorMap& x, const CUtensorMap& y, const CUtensorMap& a,
               const CUtensorMap& b, const CUtensorMap& c, const float* bias, const float* lse,
               float* delta, const int32_t* seed, const int32_t* rix, bf16* out0, bf16* out1,
               int bh, int n, int nt, int heads, int heads_total, int head0, int grid, int tpg,
               float scale, uint32_t thr, float drop_scale, cudaStream_t stream) {
  const int smem = layout(nt, ROLE, D).smem;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_sm90_kernel<ROLE, TAIL, D, DROP, GROUPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = ((n + BOX - 1) / BOX + tpg - 1) / tpg;
  attn_bwd_sm90_kernel<ROLE, TAIL, D, DROP, GROUPS>
      <<<dim3(grid, groups), THREADS, smem, stream>>>(
      x, y, a, b, c, bias, lse, delta, seed, rix, out0, out1, bh, n, nt, heads, heads_total,
      head0, tpg, scale, thr, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

// DQ, then DKDV (which reads the delta DQ writes), both on `stream`
template <int TAIL, int D, bool DROP, bool GROUPS>
int launch(const CUtensorMap (&m)[5], const float* bias, const int32_t* seed,
           const int32_t* rix, const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv,
           int bh, int heads, int heads_total, int head0, int n, int nt, int grid, int tpg,
           float scale, uint32_t thr, float drop_scale, cudaStream_t st) {
  enum { Q, K, V, O, DO };
  int rc = launch_one<DQ, TAIL, D, DROP, GROUPS>(m[K], m[V], m[Q], m[DO], m[O], bias, lse,
                                                 delta, seed, rix, dq, nullptr, bh, n, nt, heads,
                                                 heads_total, head0, grid, tpg, scale, thr,
                                                 drop_scale, st);
  if (rc != 0) return rc;
  return launch_one<DKDV, TAIL, D, DROP, GROUPS>(m[Q], m[DO], m[K], m[V], m[V], bias, lse,
                                                 delta, seed, rix, dk, dv, bh, n, nt, heads,
                                                 heads_total, head0, grid, tpg, scale, thr,
                                                 drop_scale, st);
}

// launch<nt % 64, D, DROP, GROUPS>, GROUPS where a unit is less than a head
template <int D, bool DROP, bool GROUPS>
int dispatch(const CUtensorMap (&m)[5], const float* b, const int32_t* sd, const int32_t* rix,
             const float* l, float* dl, bf16* q, bf16* k, bf16* v, int bh, int heads,
             int heads_total, int head0, int n, int nt, int grid, int tpg, float scale,
             uint32_t thr, float drop_scale, cudaStream_t st) {
  auto go = [&](auto tail) {
    return launch<decltype(tail)::value, D, DROP, GROUPS>(m, b, sd, rix, l, dl, q, k, v, bh,
                                                          heads, heads_total, head0, n, nt,
                                                          grid, tpg, scale, thr, drop_scale, st);
  };
  switch (nt % BOX) {
    case 0: return go(std::integral_constant<int, 0>());
    case 16: return go(std::integral_constant<int, 16>());
    case 32: return go(std::integral_constant<int, 32>());
    default: return go(std::integral_constant<int, 48>());
  }
}

// dispatch<D, DROP, GROUPS> with DROP where there is a seed
template <int D>
int dispatch_d(const CUtensorMap (&m)[5], const float* b, const int32_t* sd, const int32_t* rix,
               const float* l, float* dl, bf16* q, bf16* k, bf16* v, int bh, int heads,
               int heads_total, int head0, int n, int nt, int grid, int tpg, float scale,
               uint32_t thr, float drop_scale, bool groups, cudaStream_t st) {
  auto go = [&](auto drop, auto grouped) {
    return dispatch<D, decltype(drop)::value, decltype(grouped)::value>(
        m, b, sd, rix, l, dl, q, k, v, bh, heads, heads_total, head0, n, nt, grid, tpg, scale,
        thr, drop_scale, st);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (sd == nullptr) return groups ? go(F(), T()) : go(F(), F());
  return groups ? go(T(), T()) : go(T(), F());
}

}  // namespace

// Encodes into `out` (128 bytes, host memory) the bf16 tensor map of a
// (bh, n, D) q, k, v, o or do at `base`: `rank` 3 dims innermost first,
// the byte strides of dims 1.., the box (D, 64, 1), D 64 or 32 (the 64-byte
// swizzle). Returns a cudaError_t.
extern "C" int flash_attention_bwd_sm90_encode(void* out, const void* base, int rank,
                                               const uint64_t* dims,
                                               const uint64_t* strides_bytes,
                                               const uint32_t* box) {
  if (rank != 3 || dims[0] != box[0] || box[1] != BOX || box[2] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return emm_encode_head_map(out, base, rank, dims, strides_bytes, box);
}

// The dynamic shared memory of the dq (role 0) or dk/dv (role 1) kernel at
// key width `nt` and head dim `d`, -1 for an (nt, d) it does not take.
extern "C" int flash_attention_bwd_sm90_smem(int nt, int role, int d) {
  if (nt <= 0 || nt > MAX_NT || nt % 16 != 0 || (role != DQ && role != DKDV) ||
      (d != 32 && d != 64))
    return -1;
  return layout(nt, role, d).smem;
}

// mq, mk, mv, mo, mdo: the maps of q, k, v, o, do, each (bh, n, d) bf16
// (from `flash_attention_bwd_sm90_encode`, host memory), d the head dim,
// 64 or 32; bias (bh / heads, n) fp32; seed: null for the backward without
// dropout, else one int32 on the device, with which it keeps the forward's
// dropout (where the hash bits are >= threshold, scaled by drop_scale);
// row_index: null (each row's own index), or (bh / heads) int32 on the
// device, each row's index in the global batch, which keys its heads'
// masks (with a seed only); heads_total, head0: the call holds heads head0
// .. head0 + heads - 1 of each row's heads_total (tensor parallelism),
// which key the masks by their global index (heads and 0 otherwise); lse
// (bh, n) fp32 from the forward; delta (bh, n) fp32 scratch; dq, dk, dv
// (bh, n, d) bf16. `nt`: the key width, n rounded up to 16 (n <= nt <=
// 512); `tpg`: 64-row tiles per work unit (>= 1); `grid`: persistent CTAs
// per tile group, 1..bh (the launch has ceil(ceil(n / 64) / tpg) groups
// along y). Launches two kernels on `stream`; returns the first launch
// error as cudaError_t.
extern "C" int flash_attention_bwd_sm90(const void* mq, const void* mk, const void* mv,
                                        const void* mo, const void* mdo, const void* bias,
                                        const void* seed, const void* row_index,
                                        const void* lse, void* delta, void* dq,
                                        void* dk, void* dv, int bh, int heads,
                                        int heads_total, int head0, int n, int nt, int grid,
                                        int tpg, float scale, unsigned threshold,
                                        float drop_scale, int d, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || n <= 0 || n > nt || nt > MAX_NT ||
      nt % 16 != 0 || tpg <= 0 || grid <= 0 || grid > bh || head0 < 0 ||
      head0 + heads > heads_total || (d != 32 && d != 64) ||
      (row_index != nullptr && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[5];
  const void* maps[5] = {mq, mk, mv, mo, mdo};
  for (int k = 0; k < 5; ++k) memcpy(&m[k], maps[k], sizeof(CUtensorMap));
  const auto* b = static_cast<const float*>(bias);
  const auto* sd = static_cast<const int32_t*>(seed);
  const auto* rix = static_cast<const int32_t*>(row_index);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* q = static_cast<bf16*>(dq);
  auto* k = static_cast<bf16*>(dk);
  auto* v = static_cast<bf16*>(dv);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool groups = tpg < (n + BOX - 1) / BOX;
  const uint32_t thr = sd == nullptr ? 0u : threshold;
  const float ds = sd == nullptr ? 1.f : drop_scale;
  return d == 64 ? dispatch_d<64>(m, b, sd, rix, l, dl, q, k, v, bh, heads, heads_total, head0,
                                  n, nt, grid, tpg, scale, thr, ds, groups, st)
                 : dispatch_d<32>(m, b, sd, rix, l, dl, q, k, v, bh, heads, heads_total, head0,
                                  n, nt, grid, tpg, scale, thr, ds, groups, st);
}
