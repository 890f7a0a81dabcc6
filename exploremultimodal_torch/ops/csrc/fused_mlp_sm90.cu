// Fused bf16 MLP forward for Hopper (sm_90a) on wgmma and TMA:
//   y = [dropout](gelu_tanh(x . W1^T + b1)) . W2^T + b2
//
// Replaces two Pallas kernels of exploremultimodal_tpu/ops/mlp_pallas.py:
// `_mlp_kernel` (:56, launched by `_fused_mlp_padded` :122) and, with DROP
// set, `_mlp_dropout_kernel` (:69, launched at :110). Same function and
// rounding: bf16 operands, fp32 accumulation, fp32 biases, tanh-form gelu
// in fp32, the hidden rounded to bf16 before the second product, the output
// stored as bf16. The (M, hidden) intermediate never reaches device memory.
// With DROP the hidden is dropped between the gelu and the rounding, from
// uint16 bits the caller drew (M, hidden), in fp32 as `_mlp_dropout_kernel`
// does: h = u >= t ? h * 65536 / (65536 - t) : 0. The bits arrive as the
// int16 u - 32768 (the port's storage of a uint16 draw u), so the kernel
// flips each top bit to read u.
//
// Widths: K = N of the presets the JAX package sends to its kernel
// (`fits_vmem`): 96 (vlmo_debug, hidden 384), 192 (vlmo_tiny, 768), 384
// (vlmo_small, 1,536) and 768 (vlmo_base, 3,072), each an instantiation of
// its own; any hidden of whole 64-column chunks. At 96, not a multiple of
// the 64-column box, x's and W1's second box runs 32 columns past K and
// W2's second box 32 rows past N: TMA fills them with zeros, but no product
// reads the K tail (its k16 steps are not issued) and no store writes the
// N tail, so the result does not rest on the fill. Warpgroup 1's output
// piece lies wholly past N = 96: computed on what its stage holds, not
// stored, as the pieces past N at 192 and 384. vlmo_large's 1,024 / 4,096
// fails `fits_vmem` and takes the erf chain in both packages.
//
// What bounds it on an H100: operations. At the VLMo-Base widths (K = N =
// 768, hidden 3072) it does 2 M (K H + H N) flops against about 2 M (K + N)
// bytes of activations and 9.4 MB of weights: over 1000 flops per byte at
// the path's M, far above the ~295 where the tensor cores become the limit.
//
// Design. A CTA owns BM = 64 rows of x and walks the hidden in chunks of 64
// columns; 3 warpgroups: two consumers (wgmma) and one producer warp (TMA).
//   - x's 64 x K tile stays in shared memory (96 KB at K = 768, one TMA
//     load of K / 64 boxes); the (64, N) fp32 output accumulator lives in
//     registers, in pieces of 128 columns, the first half of the pieces to
//     consumer warpgroup 0 and the rest to 1 (`pw` each: 3 at N = 768, 192
//     registers a thread; `setmaxnreg` moves registers from the producer to
//     the consumers). At N = 384 warpgroup 1's second piece, and at 192 its
//     piece's last 64 columns, lie past N: computed on what the stage
//     holds, not stored.
//   - Weights stream through a ring of NS = 3 stages of 32 KB on mbarriers,
//     in the 128-byte swizzle that wgmma reads. Per chunk: ceil(K / 256) W1
//     stages (the chunk's 64 hidden rows x 256 of K each, the last with the
//     rest of K: 3 boxes at K = 192, 2 at 384) and `pw` W2 stages (64 hidden
//     columns x one 128-row piece for each warpgroup; a box wholly past N
//     is not loaded). No whole 96 KB chunk of W1 is staged at once. The
//     shared-memory layout is the 768-wide one at every width.
//   - Per chunk: h (64 x 64) = x . W1[chunk]^T, 32 columns per warpgroup
//     (m64n32k16 from shared memory); bias, gelu, bf16 into one of two h
//     tiles in shared memory (swizzled as TMA would write it); one named
//     barrier between the two consumer warpgroups; then each warpgroup's
//     pieces of the output += h . W2[:, chunk]^T (m64n128k16). The stage
//     just read is released while the next one's wgmmas run
//     (wgmma.wait_group 1). Each group of products between its fence and
//     its commit is straight-line code (a W1 stage of 4, 3 or 2 boxes).
//   - The width is a template parameter, and the host picks the
//     instantiation: a width's stage counts, the producer's divisions by a
//     chunk's stage count and its box masks are constants. With the width
//     at run time the 768-wide kernel ran 5-9% slower on an H100
//     (`scripts/torch_compare_parent.py`).
//   - Clusters of CL = 2 CTAs along M: each weight box is loaded by one CTA
//     and multicast to both, so the L2 reads of weights fall by half (2.2 to
//     1.1 GB per call at M = 15,168). Consumers release a stage in every CTA
//     of the cluster; a producer overwrites a stage only once all have.
//   - Small M: with fewer row tiles than SMs the wrapper splits the hidden
//     over `splits` CTAs per tile (grid.y); each writes an fp32 partial of y
//     and `mlp_sum_splits` adds them in a fixed order, adds b2 and rounds:
//     deterministic, no atomics.
//   - Partial mode (tensor parallelism: this rank's share of the hidden,
//     whose fc2 is row-parallel): y is the fp32 (m, N) sum over the given
//     hidden without b2, unrounded, for the all-reduce to add to the other
//     ranks' before b2 and the one rounding. At one split the kernel
//     stores its accumulator into y; at more, `mlp_sum_splits<true>` adds
//     the splits' partials into y.
//   - Ragged M: TMA fills rows past M with zeros, and stores are guarded.
//   - DROP: each chunk's 64 x 64 tile of bits (8 KB, 128-byte rows) comes
//     by TMA through a 2D map over the caller's (M, hidden) int16 bits, in
//     the 128-byte swizzle (conflict-free reads in the gelu epilogue), into
//     one of two slots with their own full/empty barriers. Each CTA loads
//     its own rows (no multicast); the producer requests a chunk's bits with
//     the chunk's first W1 stage, at least one stage before the epilogue
//     reads them. x, the ring, the h tiles and the two slots take 229,376
//     of the 232,448 bytes a block may use. The bits add 2 bytes per hidden
//     element, which leaves the kernel bound by operations.
// What holds it back (`scripts/torch_kernel_variants.py` times variants of
// this source on an H100, K = 768): the round trip of each ring stage. A
// stage is released only once its wgmmas are done and refilled only then;
// x's resident tile leaves room for three 32 KB stages, so about one stage
// of compute covers the release, the TMA and the wait. The variant without
// the ring's synchronisation (weights left stale) runs in about 0.6 of the
// time; 16 KB stages, 128-column chunks and deeper wgmma queues were all
// slower in trials. The gelu epilogue, run by both warpgroups in step,
// idles the tensor cores about a tenth of the time. The dropout variant
// inherits the same limit. At K = 192 and 384 a chunk is 2 and 4 stages,
// and the ring's round trip weighs more on fewer products.

#include <cuda_bf16.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace emm::sm90;

constexpr int K_MAX = 768;      // the widest input (and output): vlmo_base
constexpr int BM = 64;          // rows per CTA
constexpr int HC = 64;          // hidden columns per chunk
constexpr int CL = 2;           // CTAs per cluster (along M): 1, 2 or 4
constexpr int NS = 3;           // ring stages
constexpr int STAGE = 32768;    // bytes per stage
constexpr int BOX = 8192;       // one 64 x 64 bf16 box
constexpr int SB = STAGE / BOX; // boxes per stage
constexpr int X_BYTES = K_MAX / 64 * BOX;  // x's tile at the widest K
constexpr int RING_OFF = X_BYTES;
constexpr int H_OFF = RING_OFF + NS * STAGE;
constexpr int BITS_OFF = H_OFF + 2 * BOX;  // DROP: two 64 x 64 int16 bits slots
template <bool DROP>
__host__ __device__ constexpr int bar_off() { return BITS_OFF + (DROP ? 2 * BOX : 0); }
// barriers: x, NS full, NS empty (and with DROP 2 bits full, 2 bits empty)
template <bool DROP>
__host__ __device__ constexpr int smem_bytes() { return bar_off<DROP>() + 8 * (1 + 2 * NS + 4) + 1024; }
constexpr int THREADS = 384;
static_assert(smem_bytes<true>() <= 232448, "shared memory");

// whether the kernel takes K = N = k
__host__ __device__ constexpr bool width_ok(int k) {
  return k == 96 || k == 192 || k == 384 || k == 768;
}

// x's 64-column boxes at width k, and W1's boxes of a chunk (the last one
// ragged at 96)
__host__ __device__ constexpr int k_boxes(int k) { return (k + 63) / 64; }
// a chunk's W1 stages at width k (SB boxes of K each, the last the rest)
__host__ __device__ constexpr int w1_stages(int k) { return (k_boxes(k) + SB - 1) / SB; }
// its W2 stages: the 128-column pieces of the output each warpgroup takes
__host__ __device__ constexpr int pieces(int k) { return ((k + 127) / 128 + 1) / 2; }

__device__ __forceinline__ float gelu_tanh(float h) {
  return 0.5f * h *
         (1.0f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x (m, k), W1 (hidden, k), W2 (k, hidden) through their tensor maps; b1,
// b2 fp32. `chunks` hidden chunks per CTA, from blockIdx.y * chunks. With
// `part` null, y = bf16(acc + b2); else part[blockIdx.y] (m, k) = acc. With
// DROP, `mbits` maps the (m, hidden) int16 bits; keep where u >= `thr`,
// then scale by `keep_scale`. K = N: one of the widths `width_ok` takes.
template <bool DROP, int K>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
mlp_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                const __grid_constant__ CUtensorMap mw1,
                const __grid_constant__ CUtensorMap mw2,
                const __grid_constant__ CUtensorMap mbits, const float* __restrict__ b1,
                const float* __restrict__ b2, bf16* __restrict__ y,
                float* __restrict__ part, int m, int chunks, int thr, float keep_scale) {
  static_assert(width_ok(K), "a width the kernel takes");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sx = base, ring = base + RING_OFF, sh = base + H_OFF;
  const uint32_t xfull = base + bar_off<DROP>(), full0 = xfull + 8, empty0 = full0 + 8 * NS;
  const uint32_t bfull0 = empty0 + 8 * NS, bempty0 = bfull0 + 16;  // DROP only
  const int m0 = blockIdx.x * BM;
  const int chunk0 = blockIdx.y * chunks;
  const uint32_t rank = cluster_ctarank();
  constexpr int XB = k_boxes(K);         // x's boxes, and W1's boxes of a chunk
  constexpr int S1 = w1_stages(K), PW = pieces(K);
  constexpr int PER_CHUNK = S1 + PW;     // stages a chunk takes
  // whether every W1 stage is whole boxes of K, and every warpgroup's
  // pieces lie below N (at 768 both: no box is skipped, no column guarded)
  constexpr bool W1_WHOLE = SB * S1 == XB, W2_WHOLE = 2 * PW * 128 == K;

  if (threadIdx.x == 0) {
    mbar_init(xfull, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * CL);  // each consumer warpgroup of each CTA
    }
    if (DROP) {
      for (int s = 0; s < 2; ++s) {
        mbar_init(bfull0 + 8 * s, 1);
        mbar_init(bempty0 + 8 * s, 1);  // after both consumer warpgroups read it
      }
    }
    fence_barrier_init();
  }
  cluster_sync();  // the peer's barriers exist before any multicast or remote arrive

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const uint16_t mask = (1u << CL) - 1;
      mbar_arrive_expect_tx(xfull, XB * BOX);
      for (int b = 0; b < XB; ++b) tma_load_2d(sx + b * BOX, &mx, xfull, 64 * b, m0);
      const int total = chunks * PER_CHUNK;
      for (int i = 0; i < total + NS; ++i) {
        const int s = i % NS;
        mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        if (i >= total) continue;  // the tail: every stage released cluster-wide
        const uint32_t full = full0 + 8 * s, dst = ring + s * STAGE;
        const int c = chunk0 + i / PER_CHUNK, st = i % PER_CHUNK;
        if (DROP && st == 0) {  // this CTA's bits of chunk c, into slot c % 2
          const int lc = i / PER_CHUNK, slot = lc & 1;
          mbar_wait(bempty0 + 8 * slot, ((lc >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(bfull0 + 8 * slot, BOX);
          tma_load_2d(base + BITS_OFF + slot * BOX, &mbits, bfull0 + 8 * slot, HC * c, m0);
        }
        // box b of the stage: W1 rows 64c.. (the chunk), K columns 256 st +
        // 64 b; or W2 hidden columns 64c.., output rows 128 (PW (b / 2) +
        // st - S1) + 64 (b % 2) for consumer warpgroup b / 2. The stage's
        // boxes inside K (W1) or starting below N (W2) are loaded, each by
        // one CTA of the cluster for both
        auto inside = [&](int b) {
          return st < S1 ? W1_WHOLE || SB * st + b < XB
                         : W2_WHOLE || 128 * (PW * (b / 2) + st - S1) + 64 * (b % 2) < K;
        };
        int boxes = 0;
        for (int b = 0; b < SB; ++b) boxes += inside(b);
        mbar_arrive_expect_tx(full, boxes * BOX);
        for (int b = rank * (SB / CL); b < (rank + 1) * (SB / CL); ++b) {
          if (!inside(b)) continue;
          if (st < S1)
            tma_load_2d_mc(dst + b * BOX, &mw1, full, 256 * st + 64 * b, HC * c, mask);
          else
            tma_load_2d_mc(dst + b * BOX, &mw2, full, HC * c,
                           128 * (PW * (b / 2) + st - S1) + 64 * (b % 2), mask);
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<240>();
    const int w = wg;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4;
    // stage j read: warp r of this warpgroup releases it in CTA r
    auto release = [&](int j) {
      if (lane == 0 && warp < CL) mbar_arrive_cluster(empty0 + 8 * (j % NS), warp);
    };

    float acc[3][64];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[p][i] = 0.f;
    mbar_wait(xfull, 0);

    int it = 0;
    for (int c = 0; c < chunks; ++c) {
      // h (64 x 32 of this warpgroup) = x . W1[chunk rows 32w..]^T
      float hacc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) hacc[i] = 0.f;
#pragma unroll
      for (int st = 0; st < S1; ++st) {
        const int cur = it++;
        mbar_wait(full0 + 8 * (cur % NS), (cur / NS) & 1);
        const uint32_t stage = ring + (cur % NS) * STAGE;
        // the stage's boxes of K: SB, or the rest of K in the last stage;
        // its k16 steps below K (all but 96's last two)
        auto products = [&](auto boxes) {
          fence_regs(hacc);
          wgmma_fence();
#pragma unroll
          for (int b = 0; b < decltype(boxes)::value; ++b)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              if (64 * (SB * st + b) + 16 * kk < K)
                wgmma_ss_n32(hacc, desc_sw128(sx + (SB * st + b) * BOX + 32 * kk),
                             desc_sw128(stage + b * BOX + 32 * 128 * w + 32 * kk));
          wgmma_commit();
        };
        const int rest = XB - SB * st;
        if (rest >= 4)
          products(std::integral_constant<int, 4>{});
        else if (rest == 3)
          products(std::integral_constant<int, 3>{});
        else
          products(std::integral_constant<int, 2>{});
        if (st > 0) {
          wgmma_wait<1>();
          release(cur - 1);
        }
      }
      wgmma_wait<0>();
      fence_regs(hacc);
      release(it - 1);

      // bias, gelu, [dropout,] bf16 into h tile c % 2, in the 128-byte
      // swizzle; the bits tile has the same layout
      const uint32_t hoff = H_OFF + (c & 1) * BOX;
      const uint32_t boff = BITS_OFF + (c & 1) * BOX;
      if (DROP) mbar_wait(bfull0 + 8 * (c & 1), (c >> 1) & 1);
      const float* b1c = b1 + HC * (chunk0 + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * w + 8 * j + 2 * q;
        const float2 bb = *reinterpret_cast<const float2*>(b1c + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 16 * warp + g + 8 * hh;
          const uint32_t sw = row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2));
          float h0 = gelu_tanh(hacc[4 * j + 2 * hh] + bb.x);
          float h1 = gelu_tanh(hacc[4 * j + 2 * hh + 1] + bb.y);
          if (DROP) {
            // int16 u - 32768 -> uint16 u, two columns per word
            const uint32_t u = *reinterpret_cast<const uint32_t*>(smem + boff + sw) ^ 0x80008000u;
            h0 = (u & 0xFFFFu) >= static_cast<uint32_t>(thr) ? h0 * keep_scale : 0.f;
            h1 = (u >> 16) >= static_cast<uint32_t>(thr) ? h1 * keep_scale : 0.f;
          }
          *reinterpret_cast<uint32_t*>(smem + hoff + sw) = pack_bf16(h0, h1);
        }
      }
      fence_proxy_async();
      named_bar_sync(1, 256);  // the whole 64 x 64 h tile is written (and the bits read)
      if (DROP && threadIdx.x == 0) mbar_arrive(bempty0 + 8 * (c & 1));

      // acc (this warpgroup's pieces) += h . W2[its rows, chunk]^T
      const uint32_t shc = sh + (c & 1) * BOX;
#pragma unroll
      for (int st = 0; st < PW; ++st) {
        const int cur = it++;
        mbar_wait(full0 + 8 * (cur % NS), (cur / NS) & 1);
        const uint32_t stage = ring + (cur % NS) * STAGE + w * 2 * BOX;
        fence_regs(acc[st]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128(acc[st], desc_sw128(shc + 32 * kk), desc_sw128(stage + 32 * kk));
        wgmma_commit();
        if (st > 0) {
          wgmma_wait<1>();
          release(cur - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < PW; ++p) fence_regs(acc[p]);
      release(it - 1);
    }

    // epilogue: rows past m and columns past k are not stored
#pragma unroll
    for (int p = 0; p < PW; ++p) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + 16 * warp + g + 8 * hh;
          const int col = 128 * (PW * w + p) + 8 * j + 2 * q;
          const float v0 = acc[p][4 * j + 2 * hh], v1 = acc[p][4 * j + 2 * hh + 1];
          if (row < m && (W2_WHOLE || col < K)) {
            if (part == nullptr) {
              *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * K + col) =
                  __floats2bfloat162_rn(v0 + b2[col], v1 + b2[col + 1]);
            } else {
              *reinterpret_cast<float2*>(part + ((size_t)blockIdx.y * m + row) * K + col) =
                  make_float2(v0, v1);
            }
          }
        }
    }
  }
}

// y = bf16(sum over splits of part[s] + b2), the splits added in order;
// PARTIAL: y = the fp32 sum, without b2. n output columns.
template <bool PARTIAL>
__global__ void mlp_sum_splits(const float4* __restrict__ part, const float* __restrict__ b2,
                               void* __restrict__ y, int m, int n, int splits) {
  const size_t n4 = (size_t)m * (n / 4);
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int p = 1; p < splits; ++p) {
    const float4 v = part[(size_t)p * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  if constexpr (PARTIAL) {
    static_cast<float4*>(y)[i] = s;
  } else {
    const int col = static_cast<int>((i * 4) % n);
    const float4 b = *reinterpret_cast<const float4*>(b2 + col);
    const uint2 out =
        make_uint2(pack_bf16(s.x + b.x, s.y + b.y), pack_bf16(s.z + b.z, s.w + b.w));
    *reinterpret_cast<uint2*>(static_cast<bf16*>(y) + i * 4) = out;
  }
}

}  // namespace

// Encodes into `out` (128 bytes, host memory) the tensor map of a row-major
// bf16 matrix (rows, cols) at `base`, in 64 x 64 boxes (a box past `cols`,
// at cols = 96, filled with zeros). Returns a cudaError_t.
extern "C" int fused_mlp_sm90_encode(void* out, const void* base, int rows, int cols) {
  if (rows <= 0 || cols <= 0 || cols % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * 2};
  const uint32_t box[2] = {64, 64};
  return emm_encode_bf16_map(out, base, 2, dims, strides, box);
}

// The kernel's dynamic shared memory (the same at every width), with the
// bits slots where `drop`.
extern "C" int fused_mlp_sm90_smem(int drop) {
  return drop ? smem_bytes<true>() : smem_bytes<false>();
}

namespace {

// the kernel's instantiation at width k
template <bool DROP>
cudaError_t run_kernel(dim3 grid, int smem, cudaStream_t st, const CUtensorMap& x,
                       const CUtensorMap& w1, const CUtensorMap& w2, const CUtensorMap& bits,
                       const float* b1, const float* b2, bf16* y, float* kpart, int m, int k,
                       int chunks, int thr, float keep_scale) {
  auto kernel = k == 96    ? mlp_sm90_kernel<DROP, 96>
                : k == 192 ? mlp_sm90_kernel<DROP, 192>
                : k == 384 ? mlp_sm90_kernel<DROP, 384>
                           : mlp_sm90_kernel<DROP, 768>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, st>>>(x, w1, w2, bits, b1, b2, y, kpart, m, chunks, thr,
                                      keep_scale);
  return cudaGetLastError();
}

template <bool DROP>
int launch(const void* mx, const void* mw1, const void* mw2, const void* mbits,
           const void* b1, const void* b2, void* y, void* part, int m, int k, int hdim,
           int splits, int partial, int thr, float keep_scale, void* stream) {
  if (m <= 0 || !width_ok(k) || hdim <= 0 || splits <= 0 || hdim % (HC * splits) != 0 ||
      (splits > 1 && part == nullptr) || (!partial && b2 == nullptr) ||
      (DROP && (thr <= 0 || thr >= 65536)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x, w1, w2, bits;
  memcpy(&x, mx, sizeof(x));
  memcpy(&w1, mw1, sizeof(w1));
  memcpy(&w2, mw2, sizeof(w2));
  memcpy(&bits, DROP ? mbits : mx, sizeof(bits));
  constexpr int smem = smem_bytes<DROP>();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tiles = (m + BM - 1) / BM;
  tiles += (CL - tiles % CL) % CL;  // whole clusters; spare CTAs store nothing
  // the kernel's fp32 partials: the splits' scratch, or in partial mode at
  // one split y itself; none where it rounds y
  float* kpart = static_cast<float*>(splits > 1 ? part : partial ? y : nullptr);
  cudaError_t err = run_kernel<DROP>(
      dim3(tiles, splits), smem, st, x, w1, w2, bits, static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<bf16*>(y), kpart, m, k, hdim / HC / splits,
      thr, keep_scale);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n4 = (size_t)m * (k / 4);
  const unsigned blocks = static_cast<unsigned>((n4 + 255) / 256);
  if (partial)
    mlp_sum_splits<true><<<blocks, 256, 0, st>>>(static_cast<const float4*>(part), nullptr, y,
                                                  m, k, splits);
  else
    mlp_sum_splits<false><<<blocks, 256, 0, st>>>(static_cast<const float4*>(part),
                                                   static_cast<const float*>(b2), y, m, k,
                                                   splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mx, mw1, mw2: the maps of x (m, k), W1 (hidden, k) and W2 (k, hidden),
// each in 64 x 64 boxes (from `fused_mlp_sm90_encode`, host memory); k in
// {96, 192, 384, 768}; b1 (hidden), b2 (k) fp32; y (m, k) bf16. With splits >
// 1, `part` is fp32 scratch of splits x m x k. hidden % (64 splits) == 0.
// With `partial` set, y is fp32 (m, k): the sum over this hidden without b2
// (which may be null), unrounded. Launches on `stream`; returns the first
// launch error.
extern "C" int fused_mlp_sm90(const void* mx, const void* mw1, const void* mw2, const void* b1,
                              const void* b2, void* y, void* part, int m, int k, int hdim,
                              int splits, int partial, void* stream) {
  return launch<false>(mx, mw1, mw2, nullptr, b1, b2, y, part, m, k, hdim, splits, partial, 0,
                       0.f, stream);
}

// As fused_mlp_sm90 with the hidden dropout of `_mlp_dropout_kernel`:
// mbits maps the (m, hidden) int16 bits (u - 32768 for uint16 draws u) in
// 64 x 64 boxes, as `fused_mlp_sm90_encode` encodes any 2-byte matrix; an
// element is kept where u >= threshold (0 < threshold < 65536) and then
// scaled by keep_scale = 65536 / (65536 - threshold); `partial` as there.
extern "C" int fused_mlp_sm90_drop(const void* mx, const void* mw1, const void* mw2,
                                   const void* mbits, const void* b1, const void* b2, void* y,
                                   void* part, int m, int k, int hdim, int splits, int partial,
                                   int threshold, float keep_scale, void* stream) {
  return launch<true>(mx, mw1, mw2, mbits, b1, b2, y, part, m, k, hdim, splits, partial,
                      threshold, keep_scale, stream);
}
