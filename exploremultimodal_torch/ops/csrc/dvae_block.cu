// One dVAE encoder block, fused, for Hopper (sm_90a): bf16 NHWC in and out.
//
// Replaces `_block_kernel` of exploremultimodal_tpu/ops/dvae_conv.py (:127,
// launched by `fused_encoder_block` :264). Same function, for one image:
//   h1  = conv3x3(relu(x))  + b1, zero outside the image, bf16
//   h2  = conv3x3(relu(h1)) + b2, zero outside the image, bf16
//   h3  = relu(conv3x3(relu(h2)) + b3), bf16
//   h4  = h3 . w4 + b4                                   (1x1, fp32)
//   out = bf16(ident + post_gain * h4), ident = x . wid + bid (1x1, fp32)
//         where the block changes the width, else x
//   [2x2 max-pool of out]
// Weights are bf16, biases fp32, every product accumulates in fp32 and the
// hidden tensors round to bf16 at the same points as the TPU kernel. Zeroing
// h1 and h2 outside the image is the SAME padding of the next conv
// (`_zero_border`), so a tile at the image's edge sees what a whole-image
// conv sees.
//
// What bounds it on an H100: the tensor cores. At the tokenizer's widths a
// block does 2 * (9 (cin nh + 2 nh^2) + nh cout [+ cin cout]) flops per
// pixel (4.75e5 at cin 256, nh 64) against 2 (cin + cout) bytes of x and out:
// hundreds of flops per byte, above the ~295 where memory stops being the
// limit.
//
// Design (simple first):
//   - one block of 8 warps per (image, TR x TC output tile). The TPU kernel
//     keeps all four conv kernels in VMEM; here g3's weights alone (6.3 MB)
//     are 28x a block's shared memory, so the weights stream from L2 in
//     slices of 64 input channels x 64 or 128 output channels, through two
//     shared-memory buffers filled by cp.async one slice ahead;
//   - h1 and h2 stay in shared memory with the halos their next conv reads
//     (+-2 and +-1 pixels, recomputed by the neighbouring tiles); h3 takes
//     h1's place once h2 is done, and the output tile h2's;
//   - x never sits in shared memory whole: a 64-channel slice of its window
//     (+-3 pixels, relu'd, zero outside the image) is staged for conv1, and
//     a slice of its centre for the identity conv;
//   - every conv is an implicit GEMM on mma.sync m16n8k16 (bf16 in, fp32
//     accumulate): the rows of A are pixels, gathered from the source tile
//     by ldmatrix at each tap's offset, the columns output channels; each
//     warp holds up to MT 16-pixel tiles x 64 channels of accumulators;
//   - the tile (TR x TC) shrinks as nh grows so that h1, h2, the x slice
//     and two weight buffers fit in 227 KB: 16 x 16 at nh 64, 8 x 16 at 128,
//     8 x 8 at 256; the TPU's row tile is a VMEM artefact and is not used.
// A deeper pipeline (wgmma, TMA) is work for a later change.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int KS = 64;        // input channels per K slice
constexpr int KP = KS + 8;    // smem pitch of a slice row (144 B): ldmatrix is conflict free

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint4 relu8(uint4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162 z = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __hmax2(h[i], z);
  return v;
}

// Tile and warp layout per hidden width. A stage's warps split into WN
// column groups of 64 channels and 8 / WN row groups; MT is the most
// 16-pixel tiles a warp holds at once.
template <int NH>
struct Plan;
template <>
struct Plan<64> {
  static constexpr int TR = 16, TC = 16;
  static constexpr int WN1 = 1, MT1 = 4, WN2 = 1, MT2 = 3, WN3 = 1, MT3 = 2, WN4 = 1, MT4 = 2;
};
template <>
struct Plan<128> {
  static constexpr int TR = 8, TC = 16;
  static constexpr int WN1 = 2, MT1 = 4, WN2 = 2, MT2 = 3, WN3 = 2, MT3 = 2, WN4 = 2, MT4 = 2;
};
template <>
struct Plan<256> {
  static constexpr int TR = 8, TC = 8;
  static constexpr int WN1 = 2, MT1 = 3, WN2 = 2, MT2 = 2, WN3 = 2, MT3 = 1, WN4 = 2, MT4 = 1;
};

template <int NH>
struct Layout {
  using P = Plan<NH>;
  static constexpr int TR = P::TR, TC = P::TC;
  static constexpr int R1 = (TR + 4) * (TC + 4);  // h1 pixels
  static constexpr int R2 = (TR + 2) * (TC + 2);  // h2 pixels
  static constexpr int R3 = TR * TC;              // h3 and output pixels
  static constexpr int RX = (TR + 6) * (TC + 6);  // x window pixels
  static constexpr int HP = NH + 8;               // h pitch (elements)
  static constexpr int WN_MAX = P::WN1 > 1 || P::WN2 > 1 || P::WN3 > 1 || P::WN4 > 1 ? 2 : 1;
  static constexpr int H1_OFF = 0;
  static constexpr int H2_OFF = H1_OFF + R1 * HP * 2;
  static constexpr int X_OFF = H2_OFF + R2 * HP * 2;
  static constexpr int W_OFF = X_OFF + RX * KP * 2;
  static constexpr int BYTES = W_OFF + 2 * 64 * WN_MAX * KP * 2;
  static_assert(R3 * HP <= R1 * HP, "h3 takes h1's place");
  static_assert(R3 * (64 * P::WN4 + 8) <= R2 * HP, "the output tile takes h2's place");
  static_assert(BYTES <= 227 * 1024, "shared memory");
  static_assert((R1 + 15) / 16 <= (8 / P::WN1) * P::MT1 && (R2 + 15) / 16 <= (8 / P::WN2) * P::MT2 &&
                    (R3 + 15) / 16 <= (8 / P::WN3) * P::MT3 && (R3 + 15) / 16 <= (8 / P::WN4) * P::MT4,
                "every 16-pixel tile of a stage has a warp");
  static_assert(NH % (64 * P::WN1) == 0 && NH % (64 * P::WN2) == 0 && NH % (64 * P::WN3) == 0,
                "the hidden width is whole column chunks");
};

struct Block {
  const bf16* x;
  const bf16 *w1, *w2, *w3, *w4, *wid;
  const float *b1, *b2, *b3, *b4, *bid;
  bf16* out;
  int h, w, cin, cout;
  bool has_id, pool;
  float post_gain;
};

// A GEMM stage's source of A rows: pixel p of a destination region rw wide
// reads, at tap (dy, dx), pixel (p / rw + dy, p % rw + dx) of a source
// region sw wide, at `base` (pitch elements per pixel). A resident source
// holds every channel (slice cs at column cs * KS); a staged one holds the
// current slice only (column 0), refilled by the stage functor.
struct ASrc {
  const bf16* base;
  int pitch, rw, sw;
  bool resident;
};

// Accumulate into acc the product of the region's A rows with the weight
// rows [n0, n0 + 64 WN) of w (laid out [tap][n_total][k_total]), over
// k_slices slices of KS input channels and TAPS taps. `stage(cs)` stages
// slice cs of a non-resident source. Ends with every warp past its last
// read of shared memory.
template <int WN, int MT, int TAPS, class Stage>
__device__ __forceinline__ void kloop(float (&acc)[MT][8][4], const ASrc& a,
                                      int m_count, const bf16* __restrict__ w,
                                      int n_total, int k_total, int k_slices,
                                      int n0, bf16* sW, Stage stage) {
  constexpr int WM = 8 / WN, NCW = 64 * WN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int mtiles = (m_count + 15) / 16;
  int arow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int p = (wm + i * WM) * 16 + (lane & 15);
    p = min(p, m_count - 1);
    arow[i] = ((p / a.rw) * a.sw + p % a.rw) * a.pitch + (lane >> 4) * 8;
  }
  const int steps = k_slices * TAPS;
  auto load_w = [&](int s, int buf) {
    const int cs = s / TAPS, tap = s % TAPS;
    const bf16* src = w + ((size_t)tap * n_total + n0) * k_total + cs * KS;
    bf16* dst = sW + buf * NCW * KP;
    for (int i = threadIdx.x; i < NCW * (KS / 8); i += THREADS) {
      const int r = i / (KS / 8), c = (i % (KS / 8)) * 8;
      cp_async16(dst + r * KP + c, src + (size_t)r * k_total + c);
    }
    cp_async_commit();
  };
  load_w(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int cs = s / TAPS, tap = s % TAPS;
    if (!a.resident && tap == 0) stage(cs);
    cp_async_wait_all();
    __syncthreads();  // weight slice s landed, the source slice staged
    if (s + 1 < steps) load_w(s + 1, (s + 1) & 1);
    const bf16* wb = sW + (s & 1) * NCW * KP + wn * 64 * KP;
    const int toff = ((tap / 3) * a.sw + tap % 3) * a.pitch * (TAPS == 9) +
                     (a.resident ? cs * KS : 0);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t b[8][2];
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t r[4];
        ldsm_x4(r, wb + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        b[2 * j2][0] = r[0];
        b[2 * j2][1] = r[1];
        b[2 * j2 + 1][0] = r[2];
        b[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (wm + i * WM >= mtiles) continue;  // uniform over the warp
        uint32_t af[4];
        ldsm_x4(af, a.base + arow[i] + toff + kk * 16);
#pragma unroll
        for (int j = 0; j < 8; ++j) emm::mma_16816(acc[i][j], af, b[j]);
      }
    }
    __syncthreads();  // every warp is done with weight buffer s & 1 and the staged slice
  }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][8][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// Call f(pixel, column, v0, v1) on the two accumulators (by reference) of
// each pair of adjacent columns this lane holds, for pixels below m_count.
template <int WN, int MT, class F>
__device__ __forceinline__ void each_pair(float (&acc)[MT][8][4], int m_count, int n0,
                                          F f) {
  constexpr int WM = 8 / WN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = (wm + i * WM) * 16 + g + 8 * hh;
        if (p < m_count)
          f(p, n0 + wn * 64 + j * 8 + 2 * t, acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
}

// 64-channel slice cs of x over a wr x wc window whose top-left pixel is
// (y0, x0) of image b, into dst (pitch KP): zero outside the image, relu'd
// where asked.
__device__ __forceinline__ void stage_x(bf16* dst, const Block& p, int b, int y0, int x0,
                                        int wr, int wc, int cs, bool relu) {
  for (int i = threadIdx.x; i < wr * wc * (KS / 8); i += THREADS) {
    const int pix = i / (KS / 8), c8 = (i % (KS / 8)) * 8;
    const int y = y0 + pix / wc, xx = x0 + pix % wc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (y >= 0 && y < p.h && xx >= 0 && xx < p.w) {
      v = *reinterpret_cast<const uint4*>(p.x + (((size_t)b * p.h + y) * p.w + xx) * p.cin +
                                          cs * KS + c8);
      if (relu) v = relu8(v);
    }
    *reinterpret_cast<uint4*>(dst + pix * KP + c8) = v;
  }
}


template <int NH>
__global__ void __launch_bounds__(THREADS, 1) dvae_block_kernel(const Block p) {
  using L = Layout<NH>;
  using P = Plan<NH>;
  constexpr int TR = L::TR, TC = L::TC, HP = L::HP;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sH1 = reinterpret_cast<bf16*>(smem + L::H1_OFF);
  bf16* sH2 = reinterpret_cast<bf16*>(smem + L::H2_OFF);
  bf16* sX = reinterpret_cast<bf16*>(smem + L::X_OFF);
  bf16* sW = reinterpret_cast<bf16*>(smem + L::W_OFF);
  bf16* sH3 = sH1;  // h1 is dead once h2 is done
  bf16* sO = sH2;   // h2 is dead once h3 is done

  const int ntx = (p.w + TC - 1) / TC;
  const int y0 = (blockIdx.x / ntx) * TR, x0 = (blockIdx.x % ntx) * TC, b = blockIdx.y;
  auto inside = [&](int y, int x) { return y >= 0 && y < p.h && x >= 0 && x < p.w; };
  auto no_stage = [](int) {};

  // conv1: relu(x) over the (TR+6) x (TC+6) window, staged slice by slice,
  // -> h1 over (TR+4) x (TC+4) from (y0-2, x0-2), zero outside the image
  {
    const ASrc a{sX, KP, TC + 4, TC + 6, false};
    auto stage = [&](int cs) { stage_x(sX, p, b, y0 - 3, x0 - 3, TR + 6, TC + 6, cs, true); };
    for (int n0 = 0; n0 < NH; n0 += 64 * P::WN1) {
      float acc[P::MT1][8][4];
      zero(acc);
      kloop<P::WN1, P::MT1, 9>(acc, a, L::R1, p.w1, NH, p.cin, p.cin / KS, n0, sW, stage);
      each_pair<P::WN1, P::MT1>(acc, L::R1, n0, [&](int px, int col, float& v0, float& v1) {
        const bool in = inside(y0 - 2 + px / (TC + 4), x0 - 2 + px % (TC + 4));
        *reinterpret_cast<__nv_bfloat162*>(sH1 + px * HP + col) = __floats2bfloat162_rn(
            in ? fmaxf(v0 + p.b1[col], 0.f) : 0.f, in ? fmaxf(v1 + p.b1[col + 1], 0.f) : 0.f);
      });
    }
  }
  // conv2: h1 -> h2 over (TR+2) x (TC+2) from (y0-1, x0-1), zero outside
  {
    const ASrc a{sH1, HP, TC + 2, TC + 4, true};
    for (int n0 = 0; n0 < NH; n0 += 64 * P::WN2) {
      float acc[P::MT2][8][4];
      zero(acc);
      kloop<P::WN2, P::MT2, 9>(acc, a, L::R2, p.w2, NH, NH, NH / KS, n0, sW, no_stage);
      each_pair<P::WN2, P::MT2>(acc, L::R2, n0, [&](int px, int col, float& v0, float& v1) {
        const bool in = inside(y0 - 1 + px / (TC + 2), x0 - 1 + px % (TC + 2));
        *reinterpret_cast<__nv_bfloat162*>(sH2 + px * HP + col) = __floats2bfloat162_rn(
            in ? fmaxf(v0 + p.b2[col], 0.f) : 0.f, in ? fmaxf(v1 + p.b2[col + 1], 0.f) : 0.f);
      });
    }
  }
  // conv3: h2 -> relu(h3) over the TR x TC tile
  {
    const ASrc a{sH2, HP, TC, TC + 2, true};
    for (int n0 = 0; n0 < NH; n0 += 64 * P::WN3) {
      float acc[P::MT3][8][4];
      zero(acc);
      kloop<P::WN3, P::MT3, 9>(acc, a, L::R3, p.w3, NH, NH, NH / KS, n0, sW, no_stage);
      each_pair<P::WN3, P::MT3>(acc, L::R3, n0, [&](int px, int col, float& v0, float& v1) {
        *reinterpret_cast<__nv_bfloat162*>(sH3 + px * HP + col) = __floats2bfloat162_rn(
            fmaxf(v0 + p.b3[col], 0.f), fmaxf(v1 + p.b3[col + 1], 0.f));
      });
    }
  }
  // conv4 and the identity, one chunk of output channels at a time:
  // post_gain * (h3 . w4 + b4) [+ bid + x . wid | + x], bf16, [pooled]
  {
    constexpr int NCW = 64 * P::WN4, OP = NCW + 8;
    const ASrc a3{sH3, HP, TC, TC, true};
    const ASrc ax{sX, KP, TC, TC, false};
    auto stage = [&](int cs) { stage_x(sX, p, b, y0, x0, TR, TC, cs, false); };
    for (int n0 = 0; n0 < p.cout; n0 += NCW) {
      float acc[P::MT4][8][4];
      zero(acc);
      kloop<P::WN4, P::MT4, 1>(acc, a3, L::R3, p.w4, p.cout, NH, NH / KS, n0, sW, no_stage);
      each_pair<P::WN4, P::MT4>(acc, L::R3, n0, [&](int, int col, float& v0, float& v1) {
        v0 = p.post_gain * (v0 + p.b4[col]);
        v1 = p.post_gain * (v1 + p.b4[col + 1]);
        if (p.has_id) {
          v0 += p.bid[col];
          v1 += p.bid[col + 1];
        }
      });
      if (p.has_id)
        kloop<P::WN4, P::MT4, 1>(acc, ax, L::R3, p.wid, p.cout, p.cin, p.cin / KS, n0, sW,
                                 stage);
      each_pair<P::WN4, P::MT4>(acc, L::R3, n0, [&](int px, int col, float& v0, float& v1) {
        const int y = y0 + px / TC, x = x0 + px % TC;
        if (!p.has_id && inside(y, x)) {  // ident = x (cin == cout)
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              p.x + (((size_t)b * p.h + y) * p.w + x) * p.cin + col));
          v0 = xv.x + v0;
          v1 = xv.y + v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(sO + px * OP + col - n0) =
            __floats2bfloat162_rn(v0, v1);
      });
      __syncthreads();
      if (!p.pool) {
        for (int i = threadIdx.x; i < L::R3 * (NCW / 8); i += THREADS) {
          const int px = i / (NCW / 8), c8 = (i % (NCW / 8)) * 8;
          const int y = y0 + px / TC, x = x0 + px % TC;
          if (inside(y, x))
            *reinterpret_cast<uint4*>(p.out + (((size_t)b * p.h + y) * p.w + x) * p.cout + n0 +
                                      c8) = *reinterpret_cast<const uint4*>(sO + px * OP + c8);
        }
      } else {
        const int ho = p.h / 2, wo = p.w / 2;
        for (int i = threadIdx.x; i < (L::R3 / 4) * (NCW / 8); i += THREADS) {
          const int q = i / (NCW / 8), c8 = (i % (NCW / 8)) * 8;
          const int pr = q / (TC / 2), pc = q % (TC / 2);
          const int y = y0 / 2 + pr, x = x0 / 2 + pc;
          if (y >= ho || x >= wo) continue;
          const bf16* s0 = sO + ((2 * pr) * TC + 2 * pc) * OP + c8;
          uint4 m = *reinterpret_cast<const uint4*>(s0);
          __nv_bfloat162* mh = reinterpret_cast<__nv_bfloat162*>(&m);
          const int offs[3] = {OP, TC * OP, (TC + 1) * OP};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const uint4 v = *reinterpret_cast<const uint4*>(s0 + offs[k]);
            const __nv_bfloat162* vh = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) mh[e] = __hmax2(mh[e], vh[e]);
          }
          *reinterpret_cast<uint4*>(p.out + (((size_t)b * ho + y) * wo + x) * p.cout + n0 + c8) =
              m;
        }
      }
      __syncthreads();  // the next chunk rewrites the output tile
    }
  }
}

template <int NH>
int launch(const Block& p, int batch, cudaStream_t stream) {
  using L = Layout<NH>;
  cudaError_t err = cudaFuncSetAttribute(
      dvae_block_kernel<NH>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((p.h + L::TR - 1) / L::TR) * ((p.w + L::TC - 1) / L::TC), batch);
  dvae_block_kernel<NH><<<grid, THREADS, L::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, h, w, cin) bf16 NHWC; w1: [9][nh][cin], w2, w3: [9][nh][nh]
// (tap = 3 dy + dx, then output, then input channel), w4: [cout][nh], wid:
// [cout][cin] (ignored without the identity conv), all bf16; b1..b3: nh, b4
// and bid: cout, fp32. out: (batch, h, w, cout), or (batch, h/2, w/2, cout)
// with `pool`. nh is 64, 128 or 256, cin a multiple of 64, cout of 128; the
// identity conv runs where has_id is set and is required unless cin == cout.
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int dvae_block(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* w3, const void* b3, const void* w4,
                          const void* b4, const void* wid, const void* bid, void* out,
                          int batch, int h, int w, int cin, int nh, int cout, int has_id,
                          int pool, float post_gain, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || cin <= 0 || cin % KS != 0 ||
      cout <= 0 || cout % 128 != 0 || (!has_id && cin != cout) ||
      (pool && (h % 2 != 0 || w % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Block p{static_cast<const bf16*>(x),   static_cast<const bf16*>(w1),
                static_cast<const bf16*>(w2),  static_cast<const bf16*>(w3),
                static_cast<const bf16*>(w4),  static_cast<const bf16*>(wid),
                static_cast<const float*>(b1), static_cast<const float*>(b2),
                static_cast<const float*>(b3), static_cast<const float*>(b4),
                static_cast<const float*>(bid), static_cast<bf16*>(out),
                h, w, cin, cout, has_id != 0, pool != 0, post_gain};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nh) {
    case 64: return launch<64>(p, batch, st);
    case 128: return launch<128>(p, batch, st);
    case 256: return launch<256>(p, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
