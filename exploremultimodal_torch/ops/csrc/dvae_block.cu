// One dVAE encoder block, fused, for Hopper (sm_90a) on wgmma and TMA: bf16
// NHWC in and out.
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
// h1 and h2 outside the image is the SAME padding of the next conv, so a
// tile at the image's edge sees what a whole-image conv sees.
//
// What bounds it on an H100: the tensor cores. At the tokenizer's widths a
// block does 2 (9 (cin nh + 2 nh^2) + nh cout [+ cin cout]) flops per pixel
// (4.75e5 at cin 256, nh 64) against 2 (cin + cout) bytes of x and out.
// Inside the kernel the weights are the traffic: every tile streams the
// block's whole weights (6.3 MB at g3b1) from L2.
//
// Design:
//   - Persistent CTAs, one per SM (as many clusters as fit), each walking
//     output tiles of TR x TC pixels; 3 warpgroups: two consumers (wgmma)
//     and one producer thread (TMA) with `setmaxnreg` moving registers to
//     the consumers.
//   - Every conv is an implicit GEMM on wgmma m64n64k16 with A from
//     registers: the rows of A are pixels, gathered by ldmatrix from the
//     source tile at each tap's offset (one warp covers 16 pixels, a
//     warpgroup 64); the (pixel block, 64-channel half) pieces of a stage
//     are split between the two consumer warpgroups at compile time (each
//     warpgroup's code is its own instantiation). A piece's fragments are
//     gathered, its four wgmmas issued and waited for before the next
//     piece; the other warpgroup's wgmmas fill the tensor cores meanwhile.
//     B is the weight slice (NB output x 64 input channels) in shared
//     memory, K-major in the 128-byte swizzle.
//   - Weights arrive by TMA from 3D tensor maps over the [tap][out][in]
//     layout (`_kernel_weights`) into a ring of NS stages on mbarriers;
//     consumers release a stage by arriving on its barrier, not by
//     __syncthreads. Clusters of CL = 2 CTAs: each loads half of every
//     weight slice and multicasts it to both, halving the L2 reads of
//     weights (12.9 to 6.4 GB per call at g3b1).
//   - x arrives by TMA too, 64 channels at a time, into XBUF buffers with
//     their own mbarriers (each consumer warp releases after its own
//     reads): the (TR+6) x (TC+6) window for conv1 (out-of-image pixels
//     zero-filled by TMA; relu applied to the A fragments), and the TR x TC
//     centre for the identity, as the 1x1 conv's A or, where the block
//     keeps its width, added to the output from shared memory.
//   - h1 and h2 stay in shared memory with the halos their next conv reads
//     (+-2 and +-1 pixels, recomputed by the neighbouring tiles); h3 takes
//     h1's place once h2 is done, and the output tile h2's; named barriers
//     between the two consumer warpgroups order the convs.
// Tiles (shared memory: h1 (TR+4)(TC+4)(nh+8) 2 B + h2 (TR+2)(TC+2)(nh+8)
// 2 B + XBUF x windows (TR+6)(TC+6) 128 B + NS stages of NB 128 B, each
// rounded to 1 KB, within 227 KB):
//   nh  64: 16 x 16, NB 64,  NS 7, XBUF 1: 58368+47104+62464+57344 = 225280 B;
//           conv1 recomputes 400 pixels for 256 (1.56x), conv2 324 (1.27x)
//   nh 128:  8 x 16, NB 128, NS 4, XBUF 1: 65536+49152+39936+65536 = 220160 B;
//           conv1 240 for 128 (1.88x), conv2 180 (1.41x)
//   nh 256:  8 x 8,  NB 128, NS 3, XBUF 2: 76800+53248+51200+49152 = 230400 B;
//           conv1 144 for 64 (2.25x), conv2 100 (1.56x)
// What still holds it back: at nh 256 (g3b1) the halo recompute and the
// single 64-pixel block of conv3, conv4 and the identity, which gives each
// warpgroup one n64 piece per weight stage, so the per-stage waits are not
// covered. Sharing halos across the cluster through distributed shared
// memory would remove the recompute; splitting those stages over K between
// the warpgroups would double the work per wait.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace emm::sm90;

constexpr int THREADS = 384;  // 2 consumer warpgroups + the producer's
constexpr int CL = 2;         // CTAs per cluster
constexpr int KS = 64;        // input channels per K slice

template <int NH>
struct Plan;
template <>
struct Plan<64> {
  static constexpr int TR = 16, TC = 16, NB = 64, NS = 7, XBUF = 1;
};
template <>
struct Plan<128> {
  static constexpr int TR = 8, TC = 16, NB = 128, NS = 4, XBUF = 1;
};
template <>
struct Plan<256> {
  static constexpr int TR = 8, TC = 8, NB = 128, NS = 3, XBUF = 2;
};

constexpr int up1k(int b) { return (b + 1023) / 1024 * 1024; }

template <int NH>
struct Layout {
  using P = Plan<NH>;
  static constexpr int TR = P::TR, TC = P::TC, NB = P::NB, NS = P::NS, XBUF = P::XBUF;
  static constexpr int NPC = NB / 64;                // 64-channel halves of a slice
  static constexpr int R1 = (TR + 4) * (TC + 4);     // h1 pixels
  static constexpr int R2 = (TR + 2) * (TC + 2);     // h2 pixels
  static constexpr int R3 = TR * TC;                 // h3 and output pixels
  static constexpr int RX = (TR + 6) * (TC + 6);     // x window pixels
  static constexpr int HP = NH + 8;                  // h pitch (elements)
  static constexpr int OP = NB + 8;                  // output staging pitch
  static constexpr int MB1 = (R1 + 63) / 64, MB2 = (R2 + 63) / 64, MB3 = (R3 + 63) / 64;
  static constexpr int H1_OFF = 0;
  static constexpr int H2_OFF = H1_OFF + up1k(R1 * HP * 2);
  static constexpr int X_OFF = H2_OFF + up1k(R2 * HP * 2);
  static constexpr int XB = up1k(RX * 128);
  static constexpr int W_OFF = X_OFF + XBUF * XB;
  static constexpr int WB = NB * 128;
  static constexpr int BAR_OFF = W_OFF + NS * WB;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * NS + 2 * XBUF) + 1024;  // + alignment
  static_assert(BYTES <= 232448, "shared memory");
  static_assert(R3 * HP <= R1 * HP, "h3 takes h1's place");
  static_assert(R3 * OP * 2 <= X_OFF - H2_OFF, "the output tile takes h2's place");
  static_assert(NH % NB == 0 && NB % (8 * CL) == 0, "whole slices, 8-row boxes");
};

struct Block {
  const float *b1, *b2, *b3, *b4, *bid;
  const bf16* x;
  bf16* out;
  int batch, h, w, cin, cout;
  bool has_id, pool;
  float post_gain;
};

struct __align__(64) Maps {
  CUtensorMap xw, xc, w1, w2, w3, w4, wid;  // x window, x centre, weights
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hmax2(h, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Consumer warpgroup WG's share of one GEMM stage of a conv: P pieces
// (64-pixel block, 64-channel half), PW = ceil(P / 2) per warpgroup, all
// known at compile time.
template <int P, int NPC, int WG>
struct Pieces {
  static constexpr int PW = (P + 1) / 2;
  static constexpr __device__ bool valid(int i) { return WG * PW + i < P; }
  static constexpr __device__ int mb(int i) { return (WG * PW + i) / NPC; }
  static constexpr __device__ int half(int i) { return (WG * PW + i) % NPC; }
};

// A source: the pixel of region row (p / rw, p % rw) at tap (dy, dx) reads
// source pixel (p / rw + dy) * sw + p % rw + dx of a tile at `base`, either
// 128-byte rows in the 128-byte swizzle (TMA-written x, 64 channels) or
// rows of `pitch` bytes holding every channel (h1, h2, h3).
struct ASrc {
  uint32_t base;
  int pitch, rw, sw, count;
  bool swz, relu;
};

// acc[i] += A(piece i) . W(stage)^T over one 64-channel slice at one tap;
// `chunk0` is the lane's first 16-byte chunk of the slice in a source row.
// A piece's A fragments (16 registers) are gathered, its four wgmmas issued
// and waited for before the next piece reuses the registers.
template <class PC>
__device__ __forceinline__ void mma_stage(float (&acc)[PC::PW][32], const ASrc& a, int tap,
                                          int chunk0, uint32_t wstage) {
  constexpr int PW = PC::PW;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int dy = tap / 3, dx = tap % 3;
#pragma unroll
  for (int i = 0; i < PW; ++i) {
    if (!PC::valid(i)) continue;
    const int p = min(PC::mb(i) * 64 + 16 * warp + (lane & 15), a.count - 1);
    const int q = (p / a.rw + dy) * a.sw + p % a.rw + dx;
    const uint32_t row = a.base + q * a.pitch;
    const int xr = a.swz ? (q & 7) : 0;
    uint32_t f[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_x4(f[kk], row + (((chunk0 + 2 * kk) ^ xr) << 4));
      if (a.relu) {
#pragma unroll
        for (int r = 0; r < 4; ++r) f[kk][r] = relu2(f[kk][r]);
      }
    }
    fence_regs(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64(acc[i], f[kk], desc_sw128(wstage + PC::half(i) * 8192 + 32 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[kk][r])::"memory");
  }
}

// f(pixel, column, v0, v1) on each pair of adjacent accumulator columns
// this thread holds, for pixels below `count` (and of the 64-channel half
// `only` if it is not negative); column from n0
template <class PC, class F>
__device__ __forceinline__ void each_pair(float (&acc)[PC::PW][32], int count, int n0, int only,
                                          F f) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < PC::PW; ++i) {
    if (!PC::valid(i) || (only >= 0 && PC::half(i) != only)) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = PC::mb(i) * 64 + 16 * warp + g + 8 * hh;
        if (p < count)
          f(p, n0 + PC::half(i) * 64 + 8 * j + 2 * q, acc[i][4 * j + 2 * hh],
            acc[i][4 * j + 2 * hh + 1]);
      }
  }
}

template <int PW>
__device__ __forceinline__ void zero(float (&acc)[PW][32]) {
#pragma unroll
  for (int i = 0; i < PW; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;
}

// The consumers' side of the two rings: weight stages shared by the
// cluster, x buffers local.
template <int NH>
struct Rings {
  using L = Layout<NH>;
  uint32_t w0, wfull, wempty, x0, xfull, xempty;
  int wi = 0, xi = 0;
  // the next weight stage, once landed
  __device__ __forceinline__ uint32_t w_wait() {
    mbar_wait(wfull + 8 * (wi % L::NS), (wi / L::NS) & 1);
    return w0 + (wi % L::NS) * L::WB;
  }
  // released (after the wgmmas that read it) in every CTA of the cluster:
  // warp r of each warpgroup signals CTA r
  __device__ __forceinline__ void w_release() {
    const int warp = (threadIdx.x / 32) % 4;
    if (threadIdx.x % 32 == 0 && warp < CL) mbar_arrive_cluster(wempty + 8 * (wi % L::NS), warp);
    ++wi;
  }
  __device__ __forceinline__ uint32_t x_wait() {
    mbar_wait(xfull + 8 * (xi % L::XBUF), (xi / L::XBUF) & 1);
    return x0 + (xi % L::XBUF) * L::XB;
  }
  // every warp arrives once its own reads are done
  __device__ __forceinline__ void x_release() {
    if (threadIdx.x % 32 == 0) mbar_arrive(xempty + 8 * (xi % L::XBUF));
    ++xi;
  }
};

__device__ __forceinline__ void consumers_sync() { named_bar_sync(1, 256); }

// The tiles of one consumer warpgroup (WG 0 or 1): four convs per tile,
// then the output, in the producer's order of loads.
template <int NH, int WG>
__device__ __forceinline__ void consume(const Block& p, uint32_t base, unsigned char* smem,
                                        Rings<NH>& ring, int tpi, int ntx, int per_cta) {
  using L = Layout<NH>;
  constexpr int TR = L::TR, TC = L::TC, NB = L::NB, NPC = L::NPC, HP = L::HP;
  using PC1 = Pieces<L::MB1 * NPC, NPC, WG>;
  using PC2 = Pieces<L::MB2 * NPC, NPC, WG>;
  using PC3 = Pieces<L::MB3 * NPC, NPC, WG>;
  const int tid = threadIdx.x, sel = (threadIdx.x % 32) >> 4;
  const uint32_t sh1 = base + L::H1_OFF, sh2 = base + L::H2_OFF;
  bf16* h1 = reinterpret_cast<bf16*>(smem + L::H1_OFF);
  bf16* h2 = reinterpret_cast<bf16*>(smem + L::H2_OFF);
  bf16* h3 = h1;  // h1 is dead once h2 is done
  bf16* so = h2;  // h2 is dead once h3 is done

  for (int t = 0; t < per_cta; ++t) {
    const int idx = blockIdx.x + t * gridDim.x;
    const int img = idx / tpi, y0 = (idx % tpi) / ntx * TR, x0 = (idx % tpi) % ntx * TC;
    auto inside = [&](int y, int x) {
      return img < p.batch && y >= 0 && y < p.h && x >= 0 && x < p.w;
    };

    // conv1: relu(x) over the (TR+6) x (TC+6) window -> h1 over (TR+4) x
    // (TC+4) from (y0-2, x0-2), relu'd for conv2, zero outside the image
    for (int n0 = 0; n0 < NH; n0 += NB) {
      float acc[PC1::PW][32];
      zero(acc);
      for (int cs = 0; cs < p.cin / KS; ++cs) {
        const ASrc a{ring.x_wait(), 128, TC + 4, TC + 6, L::R1, true, true};
        for (int tap = 0; tap < 9; ++tap) {
          mma_stage<PC1>(acc, a, tap, sel, ring.w_wait());
          ring.w_release();
        }
        ring.x_release();
      }
      const float* b1 = p.b1;
      each_pair<PC1>(acc, L::R1, n0, -1, [&](int px, int col, float v0, float v1) {
        const bool in = inside(y0 - 2 + px / (TC + 4), x0 - 2 + px % (TC + 4));
        const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + col));
        *reinterpret_cast<__nv_bfloat162*>(h1 + px * HP + col) = __floats2bfloat162_rn(
            in ? fmaxf(v0 + b.x, 0.f) : 0.f, in ? fmaxf(v1 + b.y, 0.f) : 0.f);
      });
    }
    consumers_sync();
    // conv2: h1 -> h2 over (TR+2) x (TC+2) from (y0-1, x0-1), relu'd, zero outside
    {
      const ASrc a{sh1, HP * 2, TC + 2, TC + 4, L::R2, false, false};
      for (int n0 = 0; n0 < NH; n0 += NB) {
        float acc[PC2::PW][32];
        zero(acc);
        for (int cs = 0; cs < NH / KS; ++cs)
          for (int tap = 0; tap < 9; ++tap) {
            mma_stage<PC2>(acc, a, tap, cs * 8 + sel, ring.w_wait());
            ring.w_release();
          }
        each_pair<PC2>(acc, L::R2, n0, -1, [&](int px, int col, float v0, float v1) {
          const bool in = inside(y0 - 1 + px / (TC + 2), x0 - 1 + px % (TC + 2));
          const float2 b = __ldg(reinterpret_cast<const float2*>(p.b2 + col));
          *reinterpret_cast<__nv_bfloat162*>(h2 + px * HP + col) = __floats2bfloat162_rn(
              in ? fmaxf(v0 + b.x, 0.f) : 0.f, in ? fmaxf(v1 + b.y, 0.f) : 0.f);
        });
      }
    }
    consumers_sync();
    // conv3: h2 -> h3 = relu(conv + b3) over the TR x TC tile, in h1's place
    {
      const ASrc a{sh2, HP * 2, TC, TC + 2, L::R3, false, false};
      for (int n0 = 0; n0 < NH; n0 += NB) {
        float acc[PC3::PW][32];
        zero(acc);
        for (int cs = 0; cs < NH / KS; ++cs)
          for (int tap = 0; tap < 9; ++tap) {
            mma_stage<PC3>(acc, a, tap, cs * 8 + sel, ring.w_wait());
            ring.w_release();
          }
        each_pair<PC3>(acc, L::R3, n0, -1, [&](int px, int col, float v0, float v1) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(p.b3 + col));
          *reinterpret_cast<__nv_bfloat162*>(h3 + px * HP + col) =
              __floats2bfloat162_rn(fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        });
      }
    }
    consumers_sync();
    // conv4 and the identity, NB output channels at a time:
    // post_gain * (h3 . w4 + b4) [+ bid + x . wid | + x], bf16, [pooled]
    {
      const ASrc a3{sh1, HP * 2, TC, TC, L::R3, false, false};
      auto stage_out = [&](int px, int col, float v0, float v1) {
        *reinterpret_cast<__nv_bfloat162*>(so + px * L::OP + col) = __floats2bfloat162_rn(v0, v1);
      };
      for (int n0 = 0; n0 < p.cout; n0 += NB) {
        float acc[PC3::PW][32];
        zero(acc);
        for (int cs = 0; cs < NH / KS; ++cs) {
          mma_stage<PC3>(acc, a3, 0, cs * 8 + sel, ring.w_wait());
          ring.w_release();
        }
        each_pair<PC3>(acc, L::R3, n0, -1, [&](int, int col, float& v0, float& v1) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(p.b4 + col));
          v0 = p.post_gain * (v0 + b.x);
          v1 = p.post_gain * (v1 + b.y);
          if (p.has_id) {
            const float2 c = __ldg(reinterpret_cast<const float2*>(p.bid + col));
            v0 += c.x;
            v1 += c.y;
          }
        });
        if (p.has_id) {
          for (int cs = 0; cs < p.cin / KS; ++cs) {
            const ASrc ax{ring.x_wait(), 128, TC, TC, L::R3, true, false};
            mma_stage<PC3>(acc, ax, 0, sel, ring.w_wait());
            ring.w_release();
            ring.x_release();
          }
          each_pair<PC3>(acc, L::R3, n0, -1, [&](int px, int col, float v0, float v1) {
            stage_out(px, col - n0, v0, v1);
          });
        } else {
          // ident = x (cin == cout): its TR x TC centre, 64 channels at a
          // time, from the x ring (TMA, 128-byte swizzle)
          for (int k = 0; k < NPC; ++k) {
            const unsigned char* xs = smem + (ring.x_wait() - base);
            each_pair<PC3>(acc, L::R3, n0, k, [&](int px, int col, float v0, float v1) {
              const int c = col - n0 - 64 * k;
              const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  xs + px * 128 + ((((c >> 3) ^ (px & 7)) << 4) | ((c & 7) * 2))));
              stage_out(px, col - n0, xv.x + v0, xv.y + v1);
            });
            ring.x_release();
          }
        }
        consumers_sync();
        if (!p.pool) {
          for (int i = tid; i < L::R3 * (NB / 8); i += 256) {
            const int px = i / (NB / 8), c8 = (i % (NB / 8)) * 8;
            const int y = y0 + px / TC, x = x0 + px % TC;
            if (inside(y, x))
              *reinterpret_cast<uint4*>(p.out + (((size_t)img * p.h + y) * p.w + x) * p.cout +
                                        n0 + c8) =
                  *reinterpret_cast<const uint4*>(so + px * L::OP + c8);
          }
        } else {
          const int ho = p.h / 2, wo = p.w / 2;
          for (int i = tid; i < (L::R3 / 4) * (NB / 8); i += 256) {
            const int qd = i / (NB / 8), c8 = (i % (NB / 8)) * 8;
            const int pr = qd / (TC / 2), pcl = qd % (TC / 2);
            const int y = y0 / 2 + pr, x = x0 / 2 + pcl;
            if (img >= p.batch || y >= ho || x >= wo) continue;
            const bf16* s0 = so + ((2 * pr) * TC + 2 * pcl) * L::OP + c8;
            uint4 m = *reinterpret_cast<const uint4*>(s0);
            __nv_bfloat162* mh = reinterpret_cast<__nv_bfloat162*>(&m);
            const int offs[3] = {L::OP, TC * L::OP, (TC + 1) * L::OP};
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const uint4 v = *reinterpret_cast<const uint4*>(s0 + offs[k]);
              const __nv_bfloat162* vh = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
              for (int e = 0; e < 4; ++e) mh[e] = __hmax2(mh[e], vh[e]);
            }
            *reinterpret_cast<uint4*>(p.out + (((size_t)img * ho + y) * wo + x) * p.cout + n0 +
                                      c8) = m;
          }
        }
        consumers_sync();  // the next chunk rewrites the output tile, the next tile h1
      }
    }
  }
}

template <int NH>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
dvae_block_kernel(const __grid_constant__ Maps maps, const Block p) {
  using L = Layout<NH>;
  constexpr int TR = L::TR, TC = L::TC, NB = L::NB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t wfull = base + L::BAR_OFF, wempty = wfull + 8 * L::NS;
  const uint32_t xfull = wempty + 8 * L::NS, xempty = xfull + 8 * L::XBUF;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::NS; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 2 * CL);  // each consumer warpgroup of each CTA
    }
    for (int s = 0; s < L::XBUF; ++s) {
      mbar_init(xfull + 8 * s, 1);
      mbar_init(xempty + 8 * s, 8);  // each consumer warp
    }
    fence_barrier_init();
  }
  cluster_sync();

  const int ntx = (p.w + TC - 1) / TC;
  const int tpi = ((p.h + TR - 1) / TR) * ntx;
  const int total = tpi * p.batch;
  const int per_cta = (total + gridDim.x - 1) / gridDim.x;  // the same in every CTA

  if (threadIdx.x >= 256) {
    // ---- producer: one thread issues every TMA load, in the consumers' order
    setmaxnreg_dec<24>();
    if (threadIdx.x != 256) return;
    const uint32_t rank = cluster_ctarank();
    const uint16_t mask = (1u << CL) - 1;
    constexpr int SUB = NB / CL;  // weight rows this CTA loads for the cluster
    int wi = 0, xi = 0;
    auto wload = [&](const CUtensorMap* m, int tap, int n0, int k0) {
      const int s = wi % L::NS;
      mbar_wait(wempty + 8 * s, ((wi / L::NS) & 1) ^ 1);
      mbar_arrive_expect_tx(wfull + 8 * s, L::WB);
      tma_load_3d_mc(base + L::W_OFF + s * L::WB + rank * SUB * 128, m, wfull + 8 * s, k0,
                     n0 + rank * SUB, tap, mask);
      ++wi;
    };
    auto xload = [&](const CUtensorMap* m, int bytes, int c0, int xx, int yy, int img) {
      const int s = xi % L::XBUF;
      mbar_wait(xempty + 8 * s, ((xi / L::XBUF) & 1) ^ 1);
      mbar_arrive_expect_tx(xfull + 8 * s, bytes);
      tma_load_4d(base + L::X_OFF + s * L::XB, m, xfull + 8 * s, c0, xx, yy, img);
      ++xi;
    };
    for (int t = 0; t < per_cta; ++t) {
      const int idx = blockIdx.x + t * gridDim.x;  // past `total`: off the images
      const int img = idx / tpi, y0 = (idx % tpi) / ntx * TR, x0 = (idx % tpi) % ntx * TC;
      for (int n0 = 0; n0 < NH; n0 += NB)
        for (int cs = 0; cs < p.cin / KS; ++cs) {
          xload(&maps.xw, L::RX * 128, cs * KS, x0 - 3, y0 - 3, img);
          for (int tap = 0; tap < 9; ++tap) wload(&maps.w1, tap, n0, cs * KS);
        }
      for (int n0 = 0; n0 < NH; n0 += NB)
        for (int cs = 0; cs < NH / KS; ++cs)
          for (int tap = 0; tap < 9; ++tap) wload(&maps.w2, tap, n0, cs * KS);
      for (int n0 = 0; n0 < NH; n0 += NB)
        for (int cs = 0; cs < NH / KS; ++cs)
          for (int tap = 0; tap < 9; ++tap) wload(&maps.w3, tap, n0, cs * KS);
      for (int n0 = 0; n0 < p.cout; n0 += NB) {
        for (int cs = 0; cs < NH / KS; ++cs) wload(&maps.w4, 0, n0, cs * KS);
        if (p.has_id)
          for (int cs = 0; cs < p.cin / KS; ++cs) {
            xload(&maps.xc, L::R3 * 128, cs * KS, x0, y0, img);
            wload(&maps.wid, 0, n0, cs * KS);
          }
        else  // x itself for the identity, 64 channels at a time
          for (int k = 0; k < NB / KS; ++k)
            xload(&maps.xc, L::R3 * 128, n0 + k * KS, x0, y0, img);
      }
    }
    // the tail: every weight stage released by the whole cluster before exit
    for (int j = 0; j < L::NS; ++j) {
      mbar_wait(wempty + 8 * (wi % L::NS), ((wi / L::NS) & 1) ^ 1);
      ++wi;
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<240>();
  Rings<NH> ring{base + L::W_OFF, wfull, wempty, base + L::X_OFF, xfull, xempty};
  if (threadIdx.x < 128)
    consume<NH, 0>(p, base, smem, ring, tpi, ntx, per_cta);
  else
    consume<NH, 1>(p, base, smem, ring, tpi, ntx, per_cta);
}

// as many CTAs as fit on the card at once, in whole clusters, at most one
// per tile (rounded up to whole clusters)
template <int NH>
int grid_size(int tiles, int* grid) {
  using L = Layout<NH>;
  static int clusters = 0;
  if (clusters == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = L::BYTES;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, dvae_block_kernel<NH>, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  *grid = CL * min(clusters, (tiles + CL - 1) / CL);
  return 0;
}

template <int NH>
int launch(const void* const* wp, const Block& p, cudaStream_t stream) {
  using L = Layout<NH>;
  cudaError_t err = cudaFuncSetAttribute(
      dvae_block_kernel<NH>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps maps;
  const uint64_t cin = p.cin, cout = p.cout, nh = NH;
  {
    const uint64_t dims[4] = {cin, (uint64_t)p.w, (uint64_t)p.h, (uint64_t)p.batch};
    const uint64_t strides[3] = {cin * 2, cin * 2 * p.w, cin * 2 * p.w * p.h};
    const uint32_t win[4] = {64, L::TC + 6, L::TR + 6, 1};
    const uint32_t ctr[4] = {64, L::TC, L::TR, 1};
    int rc = emm_encode_bf16_map(&maps.xw, p.x, 4, dims, strides, win);
    if (rc == 0) rc = emm_encode_bf16_map(&maps.xc, p.x, 4, dims, strides, ctr);
    if (rc != 0) return rc;
  }
  // weights: [taps][n][k] bf16, boxes of 64 input x NB / CL output channels
  auto wmap = [&](CUtensorMap* m, const void* w, uint64_t k, uint64_t n, uint64_t taps) {
    const uint64_t dims[3] = {k, n, taps};
    const uint64_t strides[2] = {k * 2, k * n * 2};
    const uint32_t box[3] = {64, L::NB / CL, 1};
    return emm_encode_bf16_map(m, w, 3, dims, strides, box);
  };
  int rc = wmap(&maps.w1, wp[0], cin, nh, 9);
  if (rc == 0) rc = wmap(&maps.w2, wp[1], nh, nh, 9);
  if (rc == 0) rc = wmap(&maps.w3, wp[2], nh, nh, 9);
  if (rc == 0) rc = wmap(&maps.w4, wp[3], nh, cout, 1);
  if (rc == 0) rc = p.has_id ? wmap(&maps.wid, wp[4], cin, cout, 1) : wmap(&maps.wid, wp[3], nh, cout, 1);
  if (rc != 0) return rc;
  const int tiles = ((p.h + L::TR - 1) / L::TR) * ((p.w + L::TC - 1) / L::TC) * p.batch;
  int grid = 0;
  rc = grid_size<NH>(tiles, &grid);
  if (rc != 0) return rc;
  dvae_block_kernel<NH><<<grid, THREADS, L::BYTES, stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What the kernel at hidden width nh launches for a batch of h x w images:
// its output tile (*tr x *tc), the CTAs (*grid, whole clusters) and the
// cluster size (*cl). Returns a cudaError_t.
extern "C" int dvae_block_grid(int nh, int h, int w, int batch, int* tr, int* tc, int* grid,
                               int* cl) {
  *cl = CL;
  auto plan = [&](auto layout, auto size) {
    using L = decltype(layout);
    *tr = L::TR, *tc = L::TC;
    return size((h + L::TR - 1) / L::TR * ((w + L::TC - 1) / L::TC) * batch, grid);
  };
  switch (nh) {
    case 64: return plan(Layout<64>{}, grid_size<64>);
    case 128: return plan(Layout<128>{}, grid_size<128>);
    case 256: return plan(Layout<256>{}, grid_size<256>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: (batch, h, w, cin) bf16 NHWC; w1: [9][nh][cin], w2, w3: [9][nh][nh]
// (tap = 3 dy + dx, then output, then input channel), w4: [cout][nh], wid:
// [cout][cin] (ignored without the identity conv), all bf16; b1..b3: nh, b4
// and bid: cout, fp32. out: (batch, h, w, cout), or (batch, h/2, w/2, cout)
// with `pool`. nh is 64, 128 or 256, cin a multiple of 64, cout of nh's
// slice width (64 or 128); the identity conv runs where has_id is set and is
// required unless cin == cout. Launches on `stream`; returns a cudaError_t
// (a tensor map the driver refuses is cudaErrorInvalidValue).
extern "C" int dvae_block(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* w3, const void* b3, const void* w4,
                          const void* b4, const void* wid, const void* bid, void* out,
                          int batch, int h, int w, int cin, int nh, int cout, int has_id,
                          int pool, float post_gain, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin % KS != 0 || cout <= 0 ||
      cout % 128 != 0 || (!has_id && cin != cout) || (pool && (h % 2 != 0 || w % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Block p{static_cast<const float*>(b1), static_cast<const float*>(b2),
                static_cast<const float*>(b3), static_cast<const float*>(b4),
                static_cast<const float*>(bid), static_cast<const bf16*>(x),
                static_cast<bf16*>(out), batch, h, w, cin, cout, has_id != 0, pool != 0,
                post_gain};
  const void* wp[5] = {w1, w2, w3, w4, wid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nh) {
    case 64: return launch<64>(wp, p, st);
    case 128: return launch<128>(wp, p, st);
    case 256: return launch<256>(wp, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
