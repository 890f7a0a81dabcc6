// W8A8 whole-MLP forward for Hopper (sm_90a) on int8 wgmma and TMA:
//   y = dequant(row_quant(h) . qW2^T) + b2,
//   h = [dropout](gelu_tanh(dequant(row_quant(x) . qW1^T) + b1))
//
// Replaces the Pallas kernels `_mlp_kernel`
// (exploremultimodal_tpu/ops/quant_pallas.py:233, launched by
// `_fused_mlp_padded` :262) and, with DROP set, `_mlp_dropout_kernel`
// (:366, launched by `_fused_mlp_dropout_padded` :399). Same function and
// rounding, step by step, bit for bit with `w8a8_mlp_fwd_plain` and
// `w8a8_mlp_fwd_drop_plain`:
//   - each bf16 row of x gets its own scale s = max(absmax, 1e-8) * (1/127)
//     and codes rint(x * (1/s)) clipped to +-127 (half to even);
//   - the int8 product with the weights' codes qW1 (H, K) is summed exactly
//     in int32, and h = (float(acc) * sx) * sw1 + b1 in fp32, then the
//     tanh-form gelu (int8_common.cuh);
//   - DROP: h is kept where the caller's uint16 bit u >= t and then scaled
//     by __fmul_rn(h, 65536 / (65536 - t)), else 0, before the row absmax of
//     h (quant_pallas.py:377-379). The bits arrive as the int16 u - 32768
//     (the port's storage of a draw), so the kernel flips each top bit. A
//     dropped h is multiplied by 0 (+-0: the same code 0 and absmax as the
//     plain version's 0);
//   - each row of h is quantized over all H columns with its own scale sh;
//   - the int8 product with qW2 (N, H) is summed in int32, and y =
//     (float(acc) * sh) * sw2 + b2, rounded once to bf16.
// Every product and sum outside the tensor cores is __fmul_rn/__fadd_rn.
//
// Widths: K = N of the presets, 192 (vlmo_tiny), 384 (vlmo_small), 768
// (vlmo_base) and 1,024 (vlmo_large), each an instantiation of its own;
// any hidden of whole 64-column chunks (vlmo_large's 4,096, and its tensor
// shares).
//
// What bounds it on an H100: operations. At the VLMo-Base shapes (K = N =
// 768, H = 3072) the two products are 2 M (K H + H N) int8 operations
// against about 2 M (K + N) bytes of activations and 4.7 MB of weight codes:
// about 1000 operations per byte at the path's M, above the ~590 where the
// int8 tensor cores become the limit. The (M, H) hidden never reaches
// device memory.
//
// The row re-quantization decides the shape of the kernel: sh needs the
// absmax of the whole (64, H) row block of h before the second product may
// start, and the block cannot hold it. So each CTA makes two passes over
// the hidden, in chunks of HC = 64 columns:
//   pass 1  the first product and the epilogue of each chunk, keeping only
//           each row's absmax of h; the two consumer warpgroups (each has 32
//           of a chunk's 64 columns) combine theirs through shared memory;
//   pass 2  for each chunk the first product and the epilogue again (bit
//           for bit the same: int32 sums are exact in any order and the
//           epilogue is the same code), h's codes at the now known sh into
//           a 64 x 64 int8 tile in shared memory, and the second product
//           accumulated, 64 x N s32 in the consumers' registers.
// That is 1.5x the operations of the two products.
//
// Registers bound the output width a pass can hold: 64 x 768 s32 is 384
// columns a consumer warpgroup, 192 registers a thread; 64 x 1,024 would be
// 256, every register a thread may have. So at N = 1,024 pass 2 runs once
// per half of the output columns (`Layout::parts`), each time computing
// every chunk's h again: 2x the operations of the two products there
// instead of 1.5x. The other ways out weighed: a cluster of two CTAs
// splitting N and trading each chunk's h codes over distributed shared
// memory (the multicast of the weight boxes along M would go, and each
// chunk would wait on the peer), and four consumer warpgroups (the
// registers of 640 threads leave ~100 a thread, below one n128
// accumulator and the rest). Pass 2 twice keeps the 768-wide kernel as it
// was and needs no new synchronisation. The width is a template parameter
// (the host picks the instantiation), so each width's layout and products
// are constants: with them at run time the 768-wide kernel ran 2-9% slower
// on an H100 (`scripts/torch_compare_parent.py`).
//
// Design, on the skeleton of fused_mlp_sm90.cu: a CTA owns BM = 64 rows;
// one producer warp (TMA) and two consumer warpgroups (int8 wgmma,
// `setmaxnreg` moves registers from the producer to them).
//   - x's codes (64 x K, 48 KB at K = 768) stay in shared memory for both
//     passes: the consumers quantize x from bf16 themselves, one warp per
//     row, into the 128-byte swizzle wgmma reads (`i8::quantize_sw128`).
//     Where K % 128 == 64 (192) the last code tile is half used.
//   - Weight codes stream through a ring of NS = 2 stages (`Layout::sb`
//     boxes of 8 KB each: 6 at K = 768, 8 at 1,024), one stage per chunk
//     and product: a chunk's W1 (its 64 rows x K bytes, 128-byte swizzle;
//     m64n32k32 per warpgroup) or its W2 for this pass's output columns (64
//     hidden bytes x 128 output rows a box, in the 64-byte swizzle since a
//     chunk's hidden is 64 bytes wide; m64n128k32). Both operands of int8
//     wgmma are K-major, which the codes already are: qW1 (H, K) and qW2
//     (N, H). A stage costs about a microsecond of synchronisation whatever
//     its size (wait, release, refill), so stages are whole chunks: on an
//     H100, nine 16 KB stages took 0.42 ms a tile, three 48 KB ones 0.25
//     and two 0.24 (scripts/torch_kernel_variants.py, K = 768).
//   - The output columns of a pass come in pieces of 128 (one W2 box), the
//     first half of them to consumer warpgroup 0 and the rest to 1, `pw`
//     each (3 at 768, 2 at 1,024 and 384, 1 at 192); at 384 warpgroup 1's
//     second piece and at 192 its piece's last 64 columns lie past N: not
//     loaded (or loaded as zeros), computed on what the stage holds, not
//     stored. Each width's products are straight-line code of their own,
//     as the 768-wide kernel's were.
//   - h's codes go to one of two 64 x 64 tiles (128-byte rows, the first 64
//     bytes used, as the A operand of the second product), alternating over
//     every chunk of pass 2; one named barrier per chunk between the two
//     warpgroups.
//   - Clusters of CL = 2 CTAs along M: each weight box is loaded by one CTA
//     and multicast to both, halving the L2 reads of weights. Consumers
//     release a stage in every CTA of the cluster; a producer overwrites a
//     stage only once all have, and drains the ring before it exits.
//   - Small M (SPLIT): where twice the row tiles still fit one wave, a
//     cluster of two CTAs along y shares each row tile, each taking half
//     the hidden's chunks. Exact: they trade their pass-1 row absmax over
//     distributed shared memory (each then has the whole row's), and write
//     their int32 sums, which `w8a8_mlp_sum_splits` adds (integers, so in
//     any order) before the same epilogue. M = 2,560 runs on 80 CTAs
//     instead of 40 (0.25 to 0.145 ms on an H100).
//   - Ragged M: rows past M quantize to zero codes and are not stored; the
//     grid is whole clusters (a spare CTA stores nothing).
//   - DROP: each chunk's 64 x 64 int16 bits (8 KB: 128-byte rows, read as
//     bytes through a 2D map over the caller's (M, 2 H) bytes, 128-byte
//     swizzle) come by TMA into NB slots past the barriers, with their own
//     full and empty barriers, with every W1 stage (each pass and part),
//     since pass 1's absmax is taken after the mask. Each CTA loads its own
//     rows and chunks (no multicast); the producer requests a chunk's bits
//     right after its W1 stage.
//   - Shared memory: x's codes, the ring, the two h tiles, 4 x 64 row scales,
//     the barriers and (DROP) the bits slots; 232,448 bytes with DROP at K =
//     1,024, all a block may use (`Layout`, mirrored by the wrapper's
//     `mlp_smem`).
// What holds it back (variants on an H100, M = 15,168, K = 768, two waves
// of 0.24 ms a tile): pass 1 about 30% (0.34 ms without it), the ring's
// synchronisation about 23% (0.38 without it). Independent accumulators
// for the chain of 24 m64n32k32 products, clusters of 1 or 4, and two
// software pipelines (a chunk's epilogue or second product beside the next
// first product; one spilled beside the 192 accumulator registers, the
// other ran 10% slower) gained nothing.
// DROP costs about 8% over the kernel without it at M = 6,304 and 7,584
// (nothing at 1,280); an evict-first L2 hint on the bits would take 3% of
// it, more bits slots issued further ahead nothing.
// The split mode, for a tensor rank's share of the hidden (`parallel=tp`,
// 1,536 of 3,072 columns at a tensor axis of 2): sh needs each row's absmax
// over the whole hidden, which no launch on one rank holds. The two passes
// above become two launches around the caller's all-reduce-max of M floats:
//   AMAX     pass 1 alone, storing each row's absmax of the share's h;
//   PARTIAL  pass 2 alone at the rows' global absmax (given), storing fp32
//            (acc * sh) * sw2 without b2, unrounded, for the ranks' fp32 sum.
// h is kept nowhere: pass 2 computes it again, bit for bit, as the whole
// kernel does, so the split costs the whole kernel's 1.5x of the two
// products and one launch more. The hidden split over a cluster of two
// (SPLIT) runs in both; in AMAX its CTAs trade their absmax as above, in
// PARTIAL the sum of the int32 parts writes fp32 without b2.
// Left for later: feeding h's codes to the second product from registers
// (the s8 A fragment does not match the s32 accumulator's layout: a byte
// permutation).

#include "int8_common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace emm::sm90;

constexpr int BM = 64;          // rows per CTA
constexpr int HC = 64;          // hidden columns per chunk
constexpr int CL = 2;           // CTAs per cluster (along M): 1 or 2
constexpr int NS = 2;           // ring stages
constexpr int BOX = 8192;       // a 64 x 128 (W1) or 128 x 64 (W2) int8 box
constexpr int NB = 2;           // DROP: bits slots
constexpr int BARS = 2 * NS + 1 + 2 * NB;  // NS full, NS empty, the peer's absmax, bits
constexpr int K_MAX = 1024;     // the widest input (and output): vlmo_large
constexpr int K_PART = 768;     // the widest output a pass of the second product holds
// the whole kernel; the split mode's first launch; its second
constexpr int WHOLE = 0, AMAX = 1, PARTIAL = 2;
constexpr int THREADS = 384;

// whether the kernel takes K = N = k
__host__ __device__ constexpr bool width_ok(int k) {
  return k == 192 || k == 384 || k == 768 || k == 1024;
}

// The shared memory at width k (K = N): x's code tiles, the ring, two h
// code tiles, x's row scales with 2 + 1 x 64 row absmax of h, the
// barriers, then (DROP) the bits slots from a 1024-byte boundary, and 1024
// bytes of slack; with the passes' output parts and pieces.
struct Layout {
  int xt;     // x's code tiles of 64 rows x 128 bytes (a W1 stage's boxes)
  int parts;  // passes of the second product, each over k / parts columns
  int pc;     // 128-column pieces of a part (the W2 boxes a stage loads)
  int pw;     // pieces a consumer warpgroup takes
  int sb;     // boxes a stage holds
  int ring_off, h_off, scale_off, bar_off, bits_off, smem;
};

__host__ __device__ constexpr Layout layout(int k, bool drop) {
  Layout l{};
  l.xt = (k + 127) / 128;
  l.parts = k > K_PART ? 2 : 1;
  l.pc = (k / l.parts + 127) / 128;
  l.pw = (l.pc + 1) / 2;
  l.sb = l.xt > 2 * l.pw ? l.xt : 2 * l.pw;
  l.ring_off = l.xt * BOX;
  l.h_off = l.ring_off + NS * l.sb * BOX;
  l.scale_off = l.h_off + 2 * BOX;
  l.bar_off = l.scale_off + 4 * BM * 4;
  l.bits_off = (l.bar_off + 8 * BARS + 1023) / 1024 * 1024;
  l.smem = l.bits_off + (drop ? NB * BOX : 0) + 1024;
  return l;
}
static_assert(layout(K_MAX, true).smem <= 232448, "shared memory with the bits slots");
static_assert(layout(768, true).smem == 183296, "the 768-wide kernel's layout");

// hacc (64 x 32 of warpgroup w) = x . W1[chunk rows 32w..]^T over all K,
// from a stage holding a chunk's W1: XT boxes of 128 K bytes, the last with
// KLAST k32 steps (2 where K % 128 == 64)
template <int XT, int KLAST>
__device__ __forceinline__ void first_product_at(int (&hacc)[16], uint32_t sxq, uint32_t stage,
                                                 int w) {
#pragma unroll
  for (int i = 0; i < 16; ++i) hacc[i] = 0;
  fence_regs(hacc);
  wgmma_fence();
#pragma unroll
  for (int b = 0; b < XT - 1; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss_s8_n32(hacc, desc_sw128(sxq + b * BOX + 32 * k),
                      desc_sw128(stage + b * BOX + 32 * 128 * w + 32 * k));
#pragma unroll
  for (int k = 0; k < KLAST; ++k)
    wgmma_ss_s8_n32(hacc, desc_sw128(sxq + (XT - 1) * BOX + 32 * k),
                    desc_sw128(stage + (XT - 1) * BOX + 32 * 128 * w + 32 * k));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(hacc);
}

// acc[p] (64 x 128) += h (64 x 64 codes at hc) . the W2 box p at `boxes`,
// for this warpgroup's PW pieces
template <int PW>
__device__ __forceinline__ void second_product_at(int (&acc)[3][64], uint32_t hc,
                                                  uint32_t boxes) {
#pragma unroll
  for (int p = 0; p < PW; ++p) fence_regs(acc[p]);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < PW; ++p)
#pragma unroll
    for (int k = 0; k < HC / 32; ++k)
      wgmma_ss_s8_n128(acc[p], desc_sw128(hc + 32 * k), desc_sw64(boxes + p * BOX + 32 * k));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < PW; ++p) fence_regs(acc[p]);
}

// W1 (hidden, k) and W2 (k, hidden) int8 codes through their tensor maps;
// x (m, k) bf16; sw1, b1 (hidden) and sw2, b2 (k) fp32; `chunks` hidden
// chunks of HC per CTA. Without SPLIT: clusters of CL CTAs along M share
// the weight boxes, and y (m, k) = bf16 result. With SPLIT: clusters of two
// CTAs along y split the hidden (CTA y takes chunks y * chunks ..), trade
// their row absmax of h, and write their int32 sums to part[y] (m, k); CTA
// 0 writes the row scales of h to shs (m); `w8a8_mlp_sum_splits` finishes.
// With DROP, `mbits` maps the (m, hidden) int16 bits as (m, 2 hidden)
// bytes; keep where u >= `thr`, then scale by `keep_scale`. MODE AMAX:
// pass 1 only, each row's absmax of h to `amax` (m); PARTIAL: pass 2 only,
// at the absmax `amax` gives, fp32 `yf` (m, k) without b2 (or, SPLIT, the
// int32 sums as above). K = N: one of the widths `width_ok` takes.
template <bool SPLIT, bool DROP, int MODE, int K>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_mlp_sm90_kernel(const __grid_constant__ CUtensorMap mw1,
                     const __grid_constant__ CUtensorMap mw2,
                     const __grid_constant__ CUtensorMap mbits, const bf16* __restrict__ x,
                     const float* __restrict__ sw1, const float* __restrict__ b1,
                     const float* __restrict__ sw2, const float* __restrict__ b2,
                     bf16* __restrict__ y, float* __restrict__ yf, float* __restrict__ amax_io,
                     int* __restrict__ part, float* __restrict__ shs_out, int m, int chunks,
                     int thr, float keep_scale) {
  static_assert(width_ok(K), "a width the kernel takes");
  constexpr int CLM = SPLIT ? 1 : CL;  // CTAs sharing the weight boxes
  constexpr Layout L = layout(K, DROP);
  constexpr int stage_bytes = L.sb * BOX;
  constexpr int XT = L.xt, PW = L.pw;
  constexpr int kpart = K / L.parts;  // output columns of a pass
  // whether a warpgroup's last piece runs past the part (384: warpgroup 1's
  // second piece; 192: its piece's last 64 columns)
  constexpr bool OVER = 2 * PW * 128 > kpart;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sxq = base, ring = base + L.ring_off, sh = base + L.h_off;
  float* sSx = reinterpret_cast<float*>(smem + L.scale_off);
  float* sAmax = sSx + BM;       // [warpgroup][row]
  float* sPeer = sAmax + 2 * BM;  // SPLIT: the other CTA's row absmax
  const uint32_t full0 = base + L.bar_off, empty0 = full0 + 8 * NS, xbar = empty0 + 8 * NS;
  const uint32_t bfull0 = xbar + 8, bempty0 = bfull0 + 8 * NB;  // DROP only
  const int m0 = blockIdx.x * BM;
  const int cbase = SPLIT ? blockIdx.y * chunks : 0;  // the first chunk of this CTA
  const uint32_t rank = cluster_ctarank();
  const uint32_t group0 = SPLIT ? rank : 0;  // the rank of the first CTA sharing the boxes

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * CLM);  // each consumer warpgroup of each sharing CTA
    }
    mbar_init(xbar, BM);  // SPLIT: one remote arrival per row
    if (DROP) {
      for (int s = 0; s < NB; ++s) {
        mbar_init(bfull0 + 8 * s, 1);
        mbar_init(bempty0 + 8 * s, 8);  // each consumer warp, once its reads are done
      }
    }
    fence_barrier_init();
  }
  cluster_sync();  // the peers' barriers exist before any multicast or remote arrive

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load, in the order the
    // consumers take the stages: pass 1 W1(0), W1(1), ..., then for each
    // part of pass 2 W1(0), W2(0), W1(1), W2(1), ...
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const uint16_t mask = ((1u << CLM) - 1) << group0;
      const int b0 = rank - group0;  // this CTA loads boxes b0, b0 + CLM, ...
      int i = 0, nb = 0;  // stages and bits loads so far
      // the next stage: chunk c's W1 (w1) or its W2 codes for part p's
      // output columns, once its slot is free in every sharing CTA; each
      // loads every CLM-th box for all. With DROP a W1 stage brings this
      // CTA's bits of chunk c after it: a bits slot frees after its chunk's
      // epilogue, a W1 stage after its product, so the stage does not wait
      // for the slot.
      auto load = [&](bool w1, int c, int p) {
        const int s = i % NS;
        mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        ++i;
        const uint32_t full = full0 + 8 * s, dst = ring + s * stage_bytes;
        const int boxes = w1 ? XT : L.pc;
        mbar_arrive_expect_tx(full, boxes * BOX);
        for (int b = b0; b < boxes; b += CLM) {
          if (w1)  // W1 rows 64c.. (the chunk), K bytes 128 b..
            tma_load_2d_mc(dst + b * BOX, &mw1, full, 128 * b, HC * (cbase + c), mask);
          else  // W2 hidden bytes 64c.., output rows kpart p + 128 b..
            tma_load_2d_mc(dst + b * BOX, &mw2, full, HC * (cbase + c), kpart * p + 128 * b,
                           mask);
        }
        if (DROP && w1) {
          const int slot = nb % NB;
          mbar_wait(bempty0 + 8 * slot, ((nb / NB) & 1) ^ 1);
          ++nb;
          mbar_arrive_expect_tx(bfull0 + 8 * slot, BOX);
          tma_load_2d(base + L.bits_off + slot * BOX, &mbits, bfull0 + 8 * slot,
                      2 * HC * (cbase + c), m0);
        }
      };
      if (MODE != PARTIAL)
        for (int c = 0; c < chunks; ++c) load(true, c, 0);  // pass 1
      if (MODE != AMAX)
        for (int p = 0; p < L.parts; ++p)
          for (int c = 0; c < chunks; ++c) {
            load(true, c, p);
            load(false, c, p);
          }
      for (int s = 0; s < NS; ++s) {  // the tail: every stage released everywhere
        mbar_wait(empty0 + 8 * (i % NS), ((i / NS) & 1) ^ 1);
        ++i;
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<240>();
  const int w = wg;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  // stage j read: warp r of this warpgroup releases it in sharing CTA r
  auto release = [&](int j) {
    if (lane == 0 && warp < CLM) mbar_arrive_cluster(empty0 + 8 * (j % NS), group0 + warp);
  };
  int it = 0;  // the next stage
  auto next_stage = [&]() {
    const int cur = it++;
    mbar_wait(full0 + 8 * (cur % NS), (cur / NS) & 1);
    return ring + (cur % NS) * stage_bytes;
  };

  // x's codes and scales, one consumer warp per row (`_row_quant`)
  i8::quantize_sw128<(K + 127) / 128 * 128>(x, m, K, m0, smem, sSx, threadIdx.x / 32, 8);
  fence_proxy_async();
  named_bar_sync(1, 256);  // x's codes and scales are whole
  // this thread's rows of the accumulators: 16 warp + g (hh = 0) and + 8
  const float sx[2] = {sSx[16 * warp + g], sSx[16 * warp + g + 8]};

  auto first_product = [&](int (&hacc)[16], uint32_t stage) {
    first_product_at<XT, K % 128 == 64 ? 2 : 4>(hacc, sxq, stage, w);
  };
  // fn(hh, col, h0, h1) for this thread's hidden values of local chunk c:
  // h0, h1 at row 16 warp + g + 8 hh, chunk columns col and col + 1; with
  // DROP, masked by the bits of the chunk's next slot, which it releases
  int kb = 0;  // DROP: bits loads consumed
  auto for_hidden = [&](const int (&hacc)[16], int c, auto fn) {
    const int slot = kb % NB;
    const unsigned char* bits = smem + L.bits_off + slot * BOX;
    if (DROP) mbar_wait(bfull0 + 8 * slot, (kb / NB) & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * w + 8 * j + 2 * q;
      const float2 s = *reinterpret_cast<const float2*>(sw1 + HC * (cbase + c) + col);
      const float2 b = *reinterpret_cast<const float2*>(b1 + HC * (cbase + c) + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float h0 = i8::hidden(hacc[4 * j + 2 * hh], sx[hh], s.x, b.x);
        float h1 = i8::hidden(hacc[4 * j + 2 * hh + 1], sx[hh], s.y, b.y);
        if (DROP) {
          // int16 u - 32768 -> uint16 u, two columns per word, 128-byte swizzle
          const int row = 16 * warp + g + 8 * hh;
          const uint32_t u = *reinterpret_cast<const uint32_t*>(
                                 bits + row * 128 + ((((col >> 3) ^ (row & 7)) << 4) |
                                                     ((col & 7) * 2))) ^
                             0x80008000u;
          // a factor of 0 or keep_scale, not a branch: a select of 0 lets the
          // compiler skip the gelu of dropped values behind a branch, which
          // cost 35% (h * 0 = +-0 takes code 0 and adds 0 to the absmax)
          h0 = __fmul_rn(h0, (u & 0xFFFFu) >= static_cast<uint32_t>(thr) ? keep_scale : 0.f);
          h1 = __fmul_rn(h1, (u >> 16) >= static_cast<uint32_t>(thr) ? keep_scale : 0.f);
        }
        fn(hh, col, h0, h1);
      }
    }
    if (DROP) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bempty0 + 8 * slot);
      ++kb;
    }
  };

  // ---- pass 1: each row's absmax of h (PARTIAL: given)
  if (MODE != PARTIAL) {
    float amax[2] = {0.f, 0.f};
    for (int c = 0; c < chunks; ++c) {
      int hacc[16];
      const int cur = it;
      first_product(hacc, next_stage());
      release(cur);
      for_hidden(hacc, c, [&](int hh, int, float h0, float h1) {
        amax[hh] = fmaxf(amax[hh], fmaxf(fabsf(h0), fabsf(h1)));
      });
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // a row lives on the 4 lanes of a quad
      amax[hh] = fmaxf(amax[hh], __shfl_xor_sync(0xffffffffu, amax[hh], 1));
      amax[hh] = fmaxf(amax[hh], __shfl_xor_sync(0xffffffffu, amax[hh], 2));
      if (q == 0) sAmax[w * BM + 16 * warp + g + 8 * hh] = amax[hh];
    }
    named_bar_sync(1, 256);  // both warpgroups' halves of every row
    if (SPLIT) {  // trade this CTA's row absmax for the other CTA's
      if (threadIdx.x < BM) {
        const int r = threadIdx.x;
        st_cluster_f32(smem_u32(sPeer + r), rank ^ 1, fmaxf(sAmax[r], sAmax[BM + r]));
        mbar_arrive_cluster(xbar, rank ^ 1);
      }
      mbar_wait_cluster(xbar, 0);
    }
  }
  if (MODE == AMAX) {  // the share's row absmax; CTA 0 of a split pair stores it
    if (threadIdx.x < BM && m0 + threadIdx.x < m && (!SPLIT || blockIdx.y == 0)) {
      const int r = threadIdx.x;
      float a = fmaxf(sAmax[r], sAmax[BM + r]);
      if (SPLIT) a = fmaxf(a, sPeer[r]);
      amax_io[m0 + r] = a;
    }
    return;
  }
  float shs[2], inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    float a;
    if (MODE == PARTIAL) {
      a = m0 + r < m ? amax_io[m0 + r] : 0.f;
    } else {
      a = fmaxf(sAmax[r], sAmax[BM + r]);
      if (SPLIT) a = fmaxf(a, sPeer[r]);
    }
    i8::row_scale(a, shs[hh], inv[hh]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + 16 * warp + g + 8 * hh;
    if (SPLIT && blockIdx.y == 0 && w == 0 && q == 0 && row < m) shs_out[row] = shs[hh];
  }

  // ---- pass 2, once per part of the output columns: h again, its codes,
  // the second product, the part's epilogue
  int tile = 0;  // h code tiles written so far (the double buffer's index)
  for (int p = 0; p < L.parts; ++p) {
    int acc[3][64];
#pragma unroll
    for (int pp = 0; pp < 3; ++pp)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[pp][i] = 0;
    for (int c = 0; c < chunks; ++c, ++tile) {
      int hacc[16];
      const int w1 = it;
      first_product(hacc, next_stage());
      release(w1);
      // h's codes into tile `tile` % 2: 128-byte rows (the first 64 bytes
      // used) in the 128-byte swizzle
      unsigned char* ht = smem + L.h_off + (tile & 1) * BOX;
      for_hidden(hacc, c, [&](int hh, int col, float h0, float h1) {
        const int row = 16 * warp + g + 8 * hh;
        const uint32_t c0 = static_cast<uint32_t>(i8::quantize(h0, inv[hh])) & 0xffu;
        const uint32_t c1 = static_cast<uint32_t>(i8::quantize(h1, inv[hh])) & 0xffu;
        *reinterpret_cast<uint16_t*>(ht + row * 128 + ((((col >> 4) ^ (row & 7)) << 4) |
                                                       (col & 15))) =
            static_cast<uint16_t>(c0 | (c1 << 8));
      });
      fence_proxy_async();
      named_bar_sync(1, 256);  // the whole 64 x 64 tile of h's codes is written

      // acc (this warpgroup's pieces) += h . W2[its rows, chunk]^T
      const int w2 = it;
      const uint32_t boxes = next_stage() + w * PW * BOX;
      const uint32_t hc = sh + (tile & 1) * BOX;
      second_product_at<PW>(acc, hc, boxes);
      release(w2);
    }

    // the part's epilogue: y = (acc * sh) * sw2 + b2, or with SPLIT the
    // int32 sums; rows past m and columns past the part not stored
#pragma unroll
    for (int pp = 0; pp < PW; ++pp) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int lc = 128 * (w * PW + pp) + 8 * j + 2 * q;  // column in the part
        if (OVER && lc >= kpart) continue;
        const int col = kpart * p + lc;
        const float2 s = *reinterpret_cast<const float2*>(sw2 + col);
        const float2 b = MODE == PARTIAL || SPLIT ? make_float2(0.f, 0.f)
                                                  : *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + 16 * warp + g + 8 * hh;
          if (row >= m) continue;
          const int a0 = acc[pp][4 * j + 2 * hh], a1 = acc[pp][4 * j + 2 * hh + 1];
          if (SPLIT) {
            *reinterpret_cast<int2*>(part + ((size_t)blockIdx.y * m + row) * K + col) =
                make_int2(a0, a1);
          } else if (MODE == PARTIAL) {
            *reinterpret_cast<float2*>(yf + (size_t)row * K + col) =
                make_float2(__fmul_rn(__fmul_rn(__int2float_rn(a0), shs[hh]), s.x),
                            __fmul_rn(__fmul_rn(__int2float_rn(a1), shs[hh]), s.y));
          } else {
            const float v0 =
                __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(a0), shs[hh]), s.x), b.x);
            const float v1 =
                __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(a1), shs[hh]), s.y), b.y);
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * K + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// y = bf16((float(part[0] + part[1]) * sh) * sw2 + b2): the split kernel's
// two int32 sums added exactly, then its epilogue; with PARTIAL, fp32 yf =
// (float(part[0] + part[1]) * sh) * sw2, without b2. n output columns.
template <bool PARTIAL>
__global__ void w8a8_mlp_sum_splits(const int4* __restrict__ part,
                                    const float* __restrict__ shs, const float* __restrict__ sw2,
                                    const float* __restrict__ b2, bf16* __restrict__ y,
                                    float* __restrict__ yf, int m, int n) {
  const size_t n4 = (size_t)m * (n / 4);
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int4 a = part[i], c = part[n4 + i];
  const int row = static_cast<int>(i / (n / 4)), col = static_cast<int>(i % (n / 4)) * 4;
  const float s = shs[row];
  const float4 w = *reinterpret_cast<const float4*>(sw2 + col);
  if (PARTIAL) {
    auto out = [&](int v, float wk) { return __fmul_rn(__fmul_rn(__int2float_rn(v), s), wk); };
    *reinterpret_cast<float4*>(yf + i * 4) = make_float4(
        out(a.x + c.x, w.x), out(a.y + c.y, w.y), out(a.z + c.z, w.z), out(a.w + c.w, w.w));
    return;
  }
  const float4 b = *reinterpret_cast<const float4*>(b2 + col);
  auto out = [&](int v, float wk, float bk) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v), s), wk), bk);
  };
  const __nv_bfloat162 lo = __floats2bfloat162_rn(out(a.x + c.x, w.x, b.x), out(a.y + c.y, w.y, b.y));
  const __nv_bfloat162 hi = __floats2bfloat162_rn(out(a.z + c.z, w.z, b.z), out(a.w + c.w, w.w, b.w));
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(y + i * 4) = v;
}

template <bool SPLIT, bool DROP, int MODE>
int launch(const CUtensorMap& w1, const CUtensorMap& w2, const CUtensorMap& bits, const void* x,
           const void* sw1, const void* b1, const void* sw2, const void* b2, void* y, void* part,
           void* shs, void* amax, int m, int k, int chunks, int grid, int thr, float keep_scale,
           cudaStream_t stream) {
  const int smem = layout(k, DROP).smem;
  auto kernel = k == 192   ? w8a8_mlp_sm90_kernel<SPLIT, DROP, MODE, 192>
                : k == 384 ? w8a8_mlp_sm90_kernel<SPLIT, DROP, MODE, 384>
                : k == 768 ? w8a8_mlp_sm90_kernel<SPLIT, DROP, MODE, 768>
                           : w8a8_mlp_sm90_kernel<SPLIT, DROP, MODE, 1024>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, SPLIT ? 2 : 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = SPLIT ? 1 : CL;
  cluster.val.clusterDim.y = SPLIT ? 2 : 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, w1, w2, bits,
                           static_cast<const bf16*>(x), static_cast<const float*>(sw1),
                           static_cast<const float*>(b1), static_cast<const float*>(sw2),
                           static_cast<const float*>(b2), static_cast<bf16*>(y),
                           static_cast<float*>(y), static_cast<float*>(amax),
                           static_cast<int*>(part), static_cast<float*>(shs), m, chunks, thr,
                           keep_scale);
  if (err != cudaSuccess || !SPLIT || MODE == AMAX) return static_cast<int>(err);
  const size_t n4 = (size_t)m * (k / 4);
  w8a8_mlp_sum_splits<MODE == PARTIAL>
      <<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, stream>>>(
          static_cast<const int4*>(part), static_cast<const float*>(shs),
          static_cast<const float*>(sw2), static_cast<const float*>(b2), static_cast<bf16*>(y),
          static_cast<float*>(y), m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Encodes into `out` (128 bytes, host memory) the tensor map of a row-major
// int8 matrix (rows, cols) at `base` in boxes of box_cols x box_rows bytes
// with the given swizzle (bytes): (128, 64, 128) for qW1 and for the
// dropout bits (an int16 (M, H) matrix read as (M, 2 H) bytes), (64, 128,
// 64) for qW2. Returns a cudaError_t.
extern "C" int w8a8_mlp_sm90_encode(void* out, const void* base, int rows, int cols,
                                    int box_cols, int box_rows, int swizzle) {
  const bool w1 = box_cols == 128 && box_rows == 64 && swizzle == 128;
  const bool w2 = box_cols == 64 && box_rows == 128 && swizzle == 64;
  if (rows <= 0 || cols <= 0 || cols % 16 != 0 || !(w1 || w2))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols)};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols), static_cast<uint32_t>(box_rows)};
  return emm_encode_map(out, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, dims, strides, box,
                        w1 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// The kernel's dynamic shared memory at width k, with the bits slots where
// `drop`; -1 where the kernel does not take k.
extern "C" int w8a8_mlp_sm90_smem(int k, int drop) {
  if (!width_ok(k)) return -1;
  return layout(k, drop != 0).smem;
}

namespace {

// checks the launch's shape and runs the kernel of `splits` (DROP with the
// bits' map `mbits`, else none) in MODE (the split modes take `amax`, and
// no b2)
template <bool DROP, int MODE>
int run(const void* mw1, const void* mw2, const void* mbits, const void* x, const void* sw1,
        const void* b1, const void* sw2, const void* b2, void* y, void* part, void* shs,
        void* amax, int m, int k, int hdim, int grid, int splits, int thr, float keep_scale,
        void* stream) {
  const int tiles = (m + BM - 1) / BM;
  const bool ok =
      m > 0 && width_ok(k) && hdim > 0 && (splits == 1 || splits == 2) &&
      hdim % (HC * splits) == 0 && (!DROP || (thr > 0 && thr < 65536)) &&
      (MODE == WHOLE || amax != nullptr) && (MODE != WHOLE || b2 != nullptr) &&
      (MODE == AMAX || y != nullptr) &&
      (splits == 1 ? grid % CL == 0 && grid >= tiles && grid <= tiles + 1
                   : grid == tiles && part != nullptr && shs != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap w1, w2, bits;
  memcpy(&w1, mw1, sizeof(w1));
  memcpy(&w2, mw2, sizeof(w2));
  memcpy(&bits, DROP ? mbits : mw1, sizeof(bits));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = hdim / HC / splits;
  return splits == 1
             ? launch<false, DROP, MODE>(w1, w2, bits, x, sw1, b1, sw2, b2, y, part, shs, amax,
                                         m, k, chunks, grid, thr, keep_scale, st)
             : launch<true, DROP, MODE>(w1, w2, bits, x, sw1, b1, sw2, b2, y, part, shs, amax,
                                        m, k, chunks, grid, thr, keep_scale, st);
}

}  // namespace

// mw1, mw2: the maps of qW1 (hidden, k) and qW2 (k, hidden) int8 (from
// `w8a8_mlp_sm90_encode`, host memory); x (m, k) bf16; sw1, b1 (hidden)
// and sw2, b2 (k) fp32; y (m, k) bf16; all contiguous and 16-byte aligned;
// k in {192, 384, 768, 1024}; hidden % (64 splits) == 0. splits 1: `grid`
// 64-row tiles in whole clusters of 2; splits 2 (the hidden split over a
// cluster of two): `grid` the 64-row tiles, `part` int32 scratch of 2 x m x
// k and `shs` fp32 scratch of m. Launches on `stream`; returns the first
// launch error.
extern "C" int w8a8_mlp_sm90(const void* mw1, const void* mw2, const void* x, const void* sw1,
                             const void* b1, const void* sw2, const void* b2, void* y,
                             void* part, void* shs, int m, int k, int hdim, int grid,
                             int splits, void* stream) {
  return run<false, WHOLE>(mw1, mw2, nullptr, x, sw1, b1, sw2, b2, y, part, shs, nullptr, m, k,
                           hdim, grid, splits, 0, 0.f, stream);
}

// As w8a8_mlp_sm90 with the hidden dropout of `_mlp_dropout_kernel`: mbits
// maps the (m, hidden) int16 bits (u - 32768 for uint16 draws u) as (m, 2
// hidden) bytes (`w8a8_mlp_sm90_encode` with the qW1 box); an element of
// the hidden is kept where u >= threshold (0 < threshold < 65536) and then
// scaled by keep_scale = 65536 / (65536 - threshold).
extern "C" int w8a8_mlp_sm90_drop(const void* mw1, const void* mw2, const void* mbits,
                                  const void* x, const void* sw1, const void* b1,
                                  const void* sw2, const void* b2, void* y, void* part,
                                  void* shs, int m, int k, int hdim, int grid, int splits,
                                  int threshold, float keep_scale, void* stream) {
  return run<true, WHOLE>(mw1, mw2, mbits, x, sw1, b1, sw2, b2, y, part, shs, nullptr, m, k,
                          hdim, grid, splits, threshold, keep_scale, stream);
}

// The split mode's first launch: each row's absmax (amax, m fp32) of the
// hidden of this share, qW1 (hidden, k), after the dropout (the _drop
// entry); sw2 and qW2's map as for its second launch, y unused. Then,
// after the caller has maxed amax over the ranks, the second launch
// (`_partial`): y (m, k) fp32 = (acc * sh) * sw2, without b2, sh from
// amax. The arguments as w8a8_mlp_sm90's, amax where b2 is; `part` and
// `shs` the scratch of splits 2.
extern "C" int w8a8_mlp_sm90_amax(const void* mw1, const void* mw2, const void* x,
                                  const void* sw1, const void* b1, const void* sw2, void* amax,
                                  void* y, void* part, void* shs, int m, int k, int hdim,
                                  int grid, int splits, void* stream) {
  return run<false, AMAX>(mw1, mw2, nullptr, x, sw1, b1, sw2, nullptr, y, part, shs, amax, m,
                          k, hdim, grid, splits, 0, 0.f, stream);
}

extern "C" int w8a8_mlp_sm90_partial(const void* mw1, const void* mw2, const void* x,
                                     const void* sw1, const void* b1, const void* sw2,
                                     void* amax, void* y, void* part, void* shs, int m, int k,
                                     int hdim, int grid, int splits, void* stream) {
  return run<false, PARTIAL>(mw1, mw2, nullptr, x, sw1, b1, sw2, nullptr, y, part, shs, amax,
                             m, k, hdim, grid, splits, 0, 0.f, stream);
}

extern "C" int w8a8_mlp_sm90_amax_drop(const void* mw1, const void* mw2, const void* mbits,
                                       const void* x, const void* sw1, const void* b1,
                                       const void* sw2, void* amax, void* y, void* part,
                                       void* shs, int m, int k, int hdim, int grid, int splits,
                                       int threshold, float keep_scale, void* stream) {
  return run<true, AMAX>(mw1, mw2, mbits, x, sw1, b1, sw2, nullptr, y, part, shs, amax, m, k,
                         hdim, grid, splits, threshold, keep_scale, stream);
}

extern "C" int w8a8_mlp_sm90_partial_drop(const void* mw1, const void* mw2, const void* mbits,
                                          const void* x, const void* sw1, const void* b1,
                                          const void* sw2, void* amax, void* y, void* part,
                                          void* shs, int m, int k, int hdim, int grid,
                                          int splits, int threshold, float keep_scale,
                                          void* stream) {
  return run<true, PARTIAL>(mw1, mw2, mbits, x, sw1, b1, sw2, nullptr, y, part, shs, amax, m,
                            k, hdim, grid, splits, threshold, keep_scale, stream);
}
