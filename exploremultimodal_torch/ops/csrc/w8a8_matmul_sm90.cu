// W8A8 matmul for Hopper (sm_90a) on int8 wgmma and TMA:
//   y = bf16((float(row_quant(x) . qw^T) * sx) * sw)
//
// Replaces the Pallas kernel `_fused_kernel`
// (exploremultimodal_tpu/ops/quant_pallas.py:48, launched by
// `_fused_w8a8_padded` :84). Same function and rounding, bit for bit with
// `w8a8_matmul_plain`: every row of the bf16 x (M, K) gets its own scale
// s = max(absmax, 1e-8) * (1/127) and codes rint(x * (1/s)) clipped to
// +-127 (half to even, as jnp.round); the int8 product with the weight codes
// qw (N, K, nn.Linear's layout) is summed exactly in int32; the epilogue is
// (float(acc) * s) * sw[n], rounded once to bf16. Every product is
// __fmul_rn. As in the TPU kernel, the CTA quantizes its rows itself, into
// shared memory: the int8 copy of x never reaches device memory.
//
// Widths: any K that is a multiple of 64 from 192 to 1,024 and any N that
// is a multiple of 64, as JAX's `fused_w8a8_matmul` takes any (K, N): the
// presets' qkv and proj (K 192, 384, 768 or 1,024; N 3 K and K) and every
// tensor rank's share of them (qkv's columns, N 3 K / T; proj's rows, K /
// T, down to 192 at vlmo_base and T = 4). K and N are arguments; two
// layouts cover the range (below).
//
// What bounds it on an H100: at the VLMo-Base shapes (qkv N = 2304, proj
// N = 768, M up to 64 * 237 rows) it does 2 M N 768 int8 operations against
// 2 bytes per element of x and y: bytes and operations cost about the same
// (about 230 operations per byte at proj, 600 at qkv against the int8
// tensor cores' ~590). So the design keeps the tensor cores fed from shared
// memory and overlaps the dequantization and y's stores with the products.
//
// Design: a CTA owns BM = 128 rows; one producer warp (TMA) and two
// consumer warpgroups (int8 wgmma, `setmaxnreg` moves registers from the
// producer to them).
//   - Each consumer warpgroup quantizes 64 of the rows from bf16 into
//     shared memory (`i8::quantize_sw128`, a warp's next row loading while
//     one is quantized), in the 128-byte swizzle wgmma reads as its A
//     operand; the CTA keeps all 128 rows' codes (96 KB at K = 768) for its
//     whole sweep over N, as the TPU kernel keeps them across its inner n
//     loop.
//   - The CTA walks output tiles of 128 rows x BN = 128 columns. A tile's
//     weight codes (128 rows of qw x K bytes) come by TMA in ceil(K / 128)
//     stages of 128 K bytes (16 KB, the 128-byte swizzle) through a ring of
//     NS stages on full/empty mbarriers. Where K % 128 == 64 the last
//     stage's boxes run past K: TMA fills those bytes with zeros, and the
//     products skip them (two k32 steps of four).
//   - Three layouts, by K (`Layout<KMAX>`): up to 384 and up to 768, room
//     for x's codes at that K (48 or 96 KB) and a ring of six stages (96
//     KB); past 768, room for K = 1,024 (128 KB) and four stages (64 KB).
//     Six stages at K = 1,024 would take 262,656 bytes of the 232,448 a
//     block may use; four take 230,976. A CTA of 64 rows would fit six, but
//     would load every weight stage once for half the products. The
//     384-wide layout is the one proj's share at K 384 (the partial mode
//     at a tensor axis of 2) has always had. vlmo_base's K (768, and 384
//     in the partial mode) is also fixed at compile time (`KFIX`) where N
//     is whole 128-column tiles: with K at run time its kernel ran 1-8%
//     slower, most at small M (`scripts/torch_compare_parent.py`).
//   - Ping-pong: the warpgroups take the CTA's tiles in turn, each a whole
//     128 x 128 tile (two m64n128k32 products a k32 step, 128 accumulator
//     registers), and an order barrier passes the tensor cores from one to
//     the other, so one warpgroup's products run while the other's epilogue
//     does. The order barrier also makes the ring's stages be taken in the
//     order they are loaded, which the parity waits on its barriers need: a
//     warpgroup running ahead could find a slot's previous load still in
//     flight and take its phase for the one it waits for. A stage is
//     released once its products are done, by a local arrive (a
//     cluster-scope release after every stage held the products to a third
//     of the rate).
//   - Epilogue: the tile is dequantized 64 rows at a time into two 64 x 64
//     bf16 boxes in shared memory (the 128-byte swizzle, so a warp's stores
//     hit 32 banks), which one thread stores by TMA; the boxes are rewritten
//     once the store has read them. TMA skips rows past M.
//   - N % 128 == 64 (qkv's share at vlmo_base and T = 4, N 576; vlmo_tiny's
//     qkv): the last tile has 64 columns. Its other 64 weight rows lie past
//     N and are not loaded; its products run whole on what the stage held
//     before, and its epilogue reads the scales of, and stores, its first
//     64 columns only. Only the run-time-K instantiations carry this: a
//     second epilogue for the half tile (or a guard in the epilogue's
//     loop) cost the fixed-K partial mode 8-10% (18-19%) on an H100 at K
//     384, N 768, where no tile is half (`scripts/torch_compare_parent.py`).
//   - Where the 128-row blocks alone leave SMs idle (the grid's y), the
//     output tiles are split over more CTAs, each quantizing its rows again:
//     M = 1,280 and 2,560 run on 60-120 CTAs instead of 10-20.
//   - Ragged M: rows past M quantize to zero codes and are not stored.
// The partial mode (PARTIAL): a tensor rank's share of a row-parallel site
// (proj at a tensor axis T: K / T of its input columns). Each row's absmax
// over the whole K comes from outside (`amax`, the ranks'
// all-reduce-max), so the share's codes are the whole call's; the weight
// codes and scales are the caller's (maxed over the ranks too); the
// epilogue stores fp32 (acc * s) * sw from the registers, unrounded, for
// the ranks' fp32 sum. qkv's column share runs the whole mode.
// What holds it back (scripts/torch_kernel_variants.py on an H100, M =
// 15,168, qkv at K = 768): the products alone take 0.014 ms, the ring and
// the x prologue bring them to 0.025; the epilogue, whose ~3.5 us a tile is
// longer than the other warpgroup's 0.8 us of products, most of the rest
// (y's stores ~0.010 ms of it; the int32 -> fp32 conversions nothing
// measurable). Multicasting the weight stages over a cluster of two cost
// 1-10% (the cross-CTA release), so each CTA loads its own.

#include <type_traits>

#include "int8_common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace emm::sm90;

constexpr int BM = 128;               // rows per CTA and per tile
constexpr int BN = 128;               // output columns per tile
constexpr int KB = 128;               // K bytes per ring stage: one swizzle row
constexpr int BOX = 8192;             // 64 rows x 128 bytes: a TMA box, in the 128-byte swizzle
constexpr int STAGE = 2 * BOX;        // 128 weight rows (output columns) x KB bytes
constexpr int K_MIN = 192;            // the widths taken: K_MIN .. K_MAX in steps of 64
constexpr int K_LOW = 384;            // the layouts' widest K: K_LOW, K_MID and K_MAX
constexpr int K_MID = 768;            // the largest K of the six-stage layouts
constexpr int K_MAX = 1024;
// the shared memory of inputs up to KMAX wide: x's codes (rows 64 h.. in
// KT boxes from h KT BOX), the ring, two 64 x 64 bf16 boxes per warpgroup,
// the rows' scales, NS full and NS empty barriers, 1024 bytes of slack
template <int KMAX>
struct Layout {
  static constexpr int NS = KMAX <= K_MID ? 6 : 4;  // ring stages
  static constexpr int KT = KMAX / KB;  // x code boxes per 64 rows
  static constexpr int X_OFF = 0;
  static constexpr int RING_OFF = X_OFF + 2 * KT * BOX;
  static constexpr int OUT_OFF = RING_OFF + NS * STAGE;
  static constexpr int SCALE_OFF = OUT_OFF + 4 * BOX;
  static constexpr int BAR_OFF = SCALE_OFF + BM * 4;
  static constexpr int SMEM = BAR_OFF + 8 * 2 * NS + 1024;
  static_assert(SMEM <= 232448, "shared memory of a block");
};
constexpr int THREADS = 384;
// named barriers: both consumer warpgroups; warpgroup w's epilogue
// (EPI + w); the order barrier that lets warpgroup w's products start (GO + w)
constexpr int ALL = 1, EPI = 2, GO = 4;


// mw: the tensor map of qw (n, k) int8 in 64-row boxes of KB bytes; my: that
// of y (m, n) bf16 in 64 x 64 boxes. x (m, k) bf16; sw (n) fp32. CTA
// (bx, by) owns rows BM bx.. and output tiles by per .. by per + per - 1
// (of `tiles`, ceil(n / BN)). PARTIAL: the rows' absmax from `amax` (m),
// and fp32 y32 (m, n) stored from the registers (my unused). KFIX: k at
// compile time (vlmo_base's 768, and its proj share 384 at T = 2 in the
// partial mode) with n % BN == 0, or 0 for `k_arg` at run time and any n
// (a last tile of 64 columns).
template <int KMAX, bool PARTIAL, int KFIX>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_matmul_sm90_kernel(const __grid_constant__ CUtensorMap mw,
                        const __grid_constant__ CUtensorMap my, const bf16* __restrict__ x,
                        const float* __restrict__ sw, const float* __restrict__ amax,
                        float* __restrict__ y32, int m, int n, int k_arg, int tiles, int per) {
  const int k = KFIX > 0 ? KFIX : k_arg;
  using L = Layout<KMAX>;
  constexpr int NS = L::NS, KT = L::KT, X_OFF = L::X_OFF, RING_OFF = L::RING_OFF;
  constexpr int OUT_OFF = L::OUT_OFF, SCALE_OFF = L::SCALE_OFF, BAR_OFF = L::BAR_OFF;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + BAR_OFF, empty0 = full0 + 8 * NS;
  const int m0 = blockIdx.x * BM;
  const int t0 = blockIdx.y * per;
  const int t1 = min(tiles, t0 + per);
  const int ksteps = (k + KB - 1) / KB;  // ring stages per tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);  // the warpgroup whose tile the stage holds
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread loads every stage, in tile order
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int i = 0;
      for (int t = t0; t < t1; ++t)
        for (int kb = 0; kb < ksteps; ++kb, ++i) {
          const int s = i % NS;
          mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s, dst = base + RING_OFF + s * STAGE;
          // the boxes holding rows below n: both, or the first of a half
          // tile (the other stays stale; its products are not stored). TMA
          // counts the zeros it fills past k as bytes of the box
          const bool both = KFIX > 0 || BN * t + 64 < n;
          mbar_arrive_expect_tx(full, both ? STAGE : BOX);
          // weight rows BN t.. and BN t + 64.. (output columns), K bytes KB kb..
          tma_load_2d(dst, &mw, full, KB * kb, BN * t);
          if (both) tma_load_2d(dst + BOX, &mw, full, KB * kb, BN * t + 64);
        }
    }
    return;
  }

  // ---- consumers: warpgroup w quantizes rows m0 + 64 w.., then takes
  // tiles t0 + w, t0 + w + 2, ...
  setmaxnreg_inc<240>();
  const int w = wg;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const uint32_t xs = base + X_OFF;
  float* scales = reinterpret_cast<float*>(smem + SCALE_OFF);
  constexpr int QK = KFIX > 0 ? KFIX : KMAX;  // the quantizer's widest K
  i8::quantize_sw128<QK>(x, m, k, m0 + 64 * w, smem + X_OFF + w * KT * BOX, scales + 64 * w,
                         warp, 4, PARTIAL ? amax : nullptr);
  fence_proxy_async();
  named_bar_sync(ALL, 256);  // every row's codes and scale
  // this thread's rows of the accumulators: 64 h + 16 warp + g (+ 8)
  float sx[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) sx[h][hh] = scales[64 * h + 16 * warp + g + 8 * hh];
  unsigned char* out = smem + OUT_OFF + w * 2 * BOX;
  const uint32_t out_s = base + OUT_OFF + w * 2 * BOX;
  const bool leader = threadIdx.x % 128 == 0;
  const int mine = (t1 - t0 - w + 1) / 2, theirs = (t1 - t0 - (1 - w) + 1) / 2;

  for (int j = 0; j < mine; ++j) {
    const int t = t0 + w + 2 * j;
    // the tile's second 64 columns lie past n (n % BN == 64, last tile);
    // never in the fixed-K instantiations
    constexpr bool TAIL = KFIX == 0;
    const bool half = TAIL && BN * t + 64 >= n;
    int it = (t - t0) * ksteps;  // the tile's first stage
    if (w == 1 || j > 0) named_bar_sync(GO + w, 256);  // the other's products are done
    int acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0;
    fence_regs(acc[0]);
    fence_regs(acc[1]);
#pragma unroll 1
    for (int kb = 0; kb < ksteps; ++kb, ++it) {
      const int s = it % NS;
      mbar_wait(full0 + 8 * s, (it / NS) & 1);
      const uint32_t stage = base + RING_OFF + s * STAGE;
      // the stage's k32 steps: 4, or 2 in the last where k % 128 == 64; each
      // group of products straight-line between its fence and its commit
      auto products = [&](auto steps) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < decltype(steps)::value; ++kk) {
          const uint64_t b = desc_sw128(stage + 32 * kk);
          wgmma_ss_s8_n128(acc[0], desc_sw128(xs + kb * BOX + 32 * kk), b);
          wgmma_ss_s8_n128(acc[1], desc_sw128(xs + (KT + kb) * BOX + 32 * kk), b);
        }
        wgmma_commit();
      };
      if ((KFIX > 0 && KFIX % KB == 0) || k - KB * kb >= KB)  // a fixed K of whole stages: always
        products(std::integral_constant<int, KB / 32>{});
      else
        products(std::integral_constant<int, KB / 64>{});
      if (kb > 0) {  // the previous stage's products are done
        wgmma_wait<1>();
        if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * ((it - 1) % NS));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * ((it - 1) % NS));
    // the other warpgroup's next tile may take the tensor cores
    if (j + w < theirs) named_bar_arrive(GO + 1 - w, 256);

    // the tile's epilogue over its first JJ 8-column groups: all 16, or 8
    // in a half tile (straight-line code either way)
    auto epilogue = [&](auto groups) {
      constexpr int JJ = decltype(groups)::value;
      if constexpr (PARTIAL) {
        // fp32 (acc * sx) * sw straight from the registers; rows past m
        // not stored
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jj = 0; jj < JJ; ++jj) {
            const int col = BN * t + 8 * jj + 2 * q;
            const float2 s = *reinterpret_cast<const float2*>(sw + col);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = m0 + 64 * h + 16 * warp + g + 8 * hh;
              if (row >= m) continue;
              *reinterpret_cast<float2*>(y32 + (size_t)row * n + col) = make_float2(
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[h][4 * jj + 2 * hh]), sx[h][hh]), s.x),
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[h][4 * jj + 2 * hh + 1]), sx[h][hh]),
                            s.y));
            }
          }
        return;
      }
      // 64 rows at a time: (acc * sx) * sw to bf16 into the two boxes (the
      // first alone in a half tile) once the last store has read them, then
      // stored by TMA
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (leader) bulk_wait_read<0>();
        named_bar_sync(EPI + w, 128);
#pragma unroll
        for (int jj = 0; jj < JJ; ++jj) {
          const float2 s = *reinterpret_cast<const float2*>(sw + BN * t + 8 * jj + 2 * q);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * warp + g + 8 * hh;
            const float v0 =
                __fmul_rn(__fmul_rn(__int2float_rn(acc[h][4 * jj + 2 * hh]), sx[h][hh]), s.x);
            const float v1 = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[h][4 * jj + 2 * hh + 1]), sx[h][hh]), s.y);
            // box jj / 8, 16-byte chunk jj % 8 of row r, swizzled
            *reinterpret_cast<__nv_bfloat162*>(out + (jj >> 3) * BOX + r * 128 +
                                               ((((jj & 7) ^ (r & 7)) << 4) | (4 * q))) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
        fence_proxy_async();
        named_bar_sync(EPI + w, 128);
        if (leader && m0 + 64 * h < m) {
          tma_store_2d(&my, out_s, BN * t, m0 + 64 * h);
          if (JJ == 16) tma_store_2d(&my, out_s + BOX, BN * t + 64, m0 + 64 * h);
          bulk_commit();
        }
      }
    };
    if constexpr (TAIL) {
      if (half)
        epilogue(std::integral_constant<int, 8>{});
      else
        epilogue(std::integral_constant<int, 16>{});
    } else {
      epilogue(std::integral_constant<int, 16>{});
    }
  }
  if (leader) bulk_wait<0>();
}

// the widest K of the layout for inputs k wide
__host__ __device__ constexpr int layout_k(int k) {
  return k <= K_LOW ? K_LOW : k <= K_MID ? K_MID : K_MAX;
}

// whether the kernel takes inputs k wide and outputs n wide
bool width_ok(int k, int n) {
  return k >= K_MIN && k <= K_MAX && k % 64 == 0 && n > 0 && n % 64 == 0;
}

}  // namespace

// Encodes into `out` (128 bytes, host memory) the tensor map of a row-major
// matrix (rows, cols) of `elem_bytes`-byte elements at `base`: 1 for the
// int8 weight codes qw (n, k), 2 for the bf16 output y (m, n); boxes of
// box_cols x box_rows elements, which must be the kernel's (128 bytes a row,
// 64 rows), in the 128-byte swizzle. Returns a cudaError_t.
extern "C" int w8a8_matmul_sm90_encode(void* out, const void* base, int rows, int cols,
                                       int box_cols, int box_rows, int elem_bytes) {
  if (rows <= 0 || cols <= 0 || (elem_bytes != 1 && elem_bytes != 2) ||
      cols * elem_bytes % 16 != 0 || box_cols * elem_bytes != KB || box_rows != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * elem_bytes};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols), static_cast<uint32_t>(box_rows)};
  return emm_encode_map(out, base,
                        elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The kernel's dynamic shared memory at input width k (that of its layout),
// or -1 where the kernel does not take k.
extern "C" int w8a8_matmul_sm90_smem(int k) {
  if (!width_ok(k, 64)) return -1;
  switch (layout_k(k)) {
    case K_LOW: return Layout<K_LOW>::SMEM;
    case K_MID: return Layout<K_MID>::SMEM;
    default: return Layout<K_MAX>::SMEM;
  }
}

namespace {

template <int KMAX, bool PARTIAL, int KFIX>
int launch_at(const CUtensorMap& w, const CUtensorMap& y, const void* x, const void* sw,
              const void* amax, void* y32, int m, int n, int k, int grid_x, int per,
              cudaStream_t stream) {
  const int tiles = (n + BN - 1) / BN;
  constexpr int smem = Layout<KMAX>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(w8a8_matmul_sm90_kernel<KMAX, PARTIAL, KFIX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  w8a8_matmul_sm90_kernel<KMAX, PARTIAL, KFIX><<<dim3(grid_x, (tiles + per - 1) / per), THREADS,
                                                 smem, stream>>>(
      w, y, static_cast<const bf16*>(x), static_cast<const float*>(sw),
      static_cast<const float*>(amax), static_cast<float*>(y32), m, n, k, tiles, per);
  return static_cast<int>(cudaGetLastError());
}

template <bool PARTIAL>
int launch(const void* mw, const void* my, const void* x, const void* sw, const void* amax,
           void* y32, int m, int n, int k, int grid_x, int per, void* stream) {
  if (m <= 0 || !width_ok(k, n) || per <= 0 || grid_x != (m + BM - 1) / BM)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap w, y;
  memcpy(&w, mw, sizeof(w));
  memcpy(&y, PARTIAL ? mw : my, sizeof(y));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // vlmo_base's widths fixed at compile time (768, and proj's share 384 in
  // the partial mode) where N has no 64-column tail; the rest at run time,
  // each in its layout
  if (k == K_MID && n % BN == 0)
    return launch_at<K_MID, PARTIAL, K_MID>(w, y, x, sw, amax, y32, m, n, k, grid_x, per, st);
  if constexpr (PARTIAL)
    if (k == K_LOW && n % BN == 0)
      return launch_at<K_LOW, true, K_LOW>(w, y, x, sw, amax, y32, m, n, k, grid_x, per, st);
  switch (layout_k(k)) {
    case K_LOW:
      return launch_at<K_LOW, PARTIAL, 0>(w, y, x, sw, amax, y32, m, n, k, grid_x, per, st);
    case K_MID:
      return launch_at<K_MID, PARTIAL, 0>(w, y, x, sw, amax, y32, m, n, k, grid_x, per, st);
    default:
      return launch_at<K_MAX, PARTIAL, 0>(w, y, x, sw, amax, y32, m, n, k, grid_x, per, st);
  }
}

}  // namespace

// mw, my: the maps of qw (n, k) int8 and y (m, n) bf16 (from
// `w8a8_matmul_sm90_encode`, host memory); x (m, k) bf16; sw (n) fp32; all
// contiguous and 16-byte aligned; k % 64 == 0 in [192, 1024], n % 64 == 0.
// `grid_x`: the 128-row blocks; `per`: output tiles of 128 columns per CTA
// along y. Launches on `stream`; returns the launch's cudaError_t.
extern "C" int w8a8_matmul_sm90(const void* mw, const void* my, const void* x, const void* sw,
                                int m, int n, int k, int grid_x, int per, void* stream) {
  return launch<false>(mw, my, x, sw, nullptr, nullptr, m, n, k, grid_x, per, stream);
}

// The partial mode: mw the map of the share's qw (n, k) int8; x (m, k)
// bf16, each row quantized at amax[row] (m fp32, its absmax over the whole
// K); sw (n) fp32; y32 (m, n) fp32 = (acc * s) * sw, unrounded. As
// w8a8_matmul_sm90 otherwise.
extern "C" int w8a8_matmul_sm90_partial(const void* mw, const void* x, const void* sw,
                                        const void* amax, void* y32, int m, int n, int k,
                                        int grid_x, int per, void* stream) {
  if (amax == nullptr || y32 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(mw, nullptr, x, sw, amax, y32, m, n, k, grid_x, per, stream);
}
