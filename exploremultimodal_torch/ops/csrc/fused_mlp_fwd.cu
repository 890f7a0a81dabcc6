// Fused bf16 MLP forward with hidden dropout for Hopper (sm_90a):
// y = dropout(gelu_tanh(x.W1^T + b1)).W2^T + b2
//
// Replaces the Pallas kernel `_mlp_dropout_kernel`
// (exploremultimodal_tpu/ops/mlp_pallas.py:69, launched at :110); the
// no-dropout forward (`_mlp_kernel`) is `fused_mlp_sm90.cu`, whose wgmma/TMA
// design this kernel has yet to take.
// Same function and rounding: bf16 operands,
// fp32 accumulation, fp32 biases, tanh-form gelu in fp32, the hidden rounded
// to bf16 before the second product, the output stored as bf16. The hidden is dropped between the gelu and the rounding, from uint16 bits
// the caller drew (M, hidden): h = bits >= t ? h * 65536 / (65536 - t) : 0,
// in fp32, as `_mlp_dropout_kernel` does. The bits arrive as int16 u - 32768
// (the port's storage of a uint16 draw u), so the kernel flips each top bit
// to read u. The bits tile of each chunk
// (BM x HC, 2 KB) arrives by cp.async with the chunk's W1 rows; the bits
// add 2 bytes per hidden element of input, which leaves the kernel bound by
// operations.
//
// What bounds it on an H100: operations. At the VLMo-Base shapes (K = N =
// 768, hidden 3072, M up to 64 * 237 rows) it does 2*M*(K*H + H*N) flops
// against about 2*M*(K + N) bytes of activations plus 9.4 MB of weights:
// over 1000 flops per byte, well above the ~295 where the tensor cores
// become the limit. The point of the fusion is that the (M, hidden)
// intermediate, 93 MB in bf16 at M = 15,168, never reaches device memory.
//
// Design (simple first):
//   - a block of 8 warps owns BM = 32 rows of x, held in shared memory;
//   - it walks the hidden dimension in chunks of HC = 32 columns: stage the
//     chunk's rows of W1 and columns of W2 in shared memory, compute
//     h = gelu(x . W1[c]^T + b1[c]), round it to bf16 into shared memory,
//     then acc += h . W2[:, c]^T;
//   - the (32, N) fp32 accumulator lives in registers, spread over the 8
//     warps (all 32 rows x N/8 columns each: 96 registers a thread at
//     N = 768);
//   - both products are mma.sync m16n8k16 (bf16 in, fp32 accumulate);
//   - the chunks arrive by cp.async, staggered over one buffer each: the
//     W2 chunk loads while the first product runs, and the next W1 chunk
//     while the second runs.
// With mma.sync every operand passes through registers, so the warp tiles
// are chosen to reuse each fragment loaded from shared memory: in the first
// product every warp computes the whole 32 x 32 chunk over one eighth of K
// (8 mma per 2 KB of fragments; the eight partial sums meet in shared
// memory), in the second a 32 x N/8 tile (24 mma per 4 KB at N = 768).
// What limits the kernel now is each block's chain of steps, not the tensor
// cores or the card's bandwidth: a block alone takes about as long as a
// full wave of them, because every 32-column chunk waits on its 96 KB of
// weights from L2 and on three barriers, with one block of 8 warps per SM
// to hide it. The register budget of the (32, N) accumulator keeps the row
// tile that small, so every block re-reads all 9.4 MB of weights. A
// deeper pipeline, a larger row tile (wgmma, accumulators spread over
// warpgroups) and TMA multicast across a cluster are work for a later
// change.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 32;       // rows per block
constexpr int HC = 32;       // hidden columns per chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = HC + 8;  // smem pitch of the W2 chunk and of h (80 B)
constexpr int LDR = HC + 4;  // smem pitch of the fp32 partial sums (144 B)
constexpr int LDB = HC + 8;  // smem pitch of the uint16 dropout bits (80 B)

__device__ __forceinline__ float gelu_tanh(float h) {
  return 0.5f * h *
         (1.0f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

// 16 bytes global -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most `N` of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// starts copying `rows` rows of `cols` 2-byte elements (cols % 8 == 0) in
// 16-byte pieces; rows from `valid_rows` on are zero-filled
template <typename T>
__device__ __forceinline__ void load_block_async(T* dst, int dst_pitch,
                                                 const T* src,
                                                 size_t src_pitch, int rows,
                                                 int cols, int valid_rows) {
  static_assert(sizeof(T) == 2, "2-byte elements");
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * dst_pitch + c, src + (size_t)(ok ? r : 0) * src_pitch + c,
               ok);
  }
}

// A fragment (16 x 16, row-major) at rows r0.., columns col.. of a bf16 tile
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile,
                                       int pitch, int r0, int col) {
  a[0] = emm::ld32(tile + r0 * pitch + col);
  a[1] = emm::ld32(tile + (r0 + 8) * pitch + col);
  a[2] = emm::ld32(tile + r0 * pitch + col + 8);
  a[3] = emm::ld32(tile + (r0 + 8) * pitch + col + 8);
}

// NT: 8-column output tiles per warp, N = 64 * NT. The hidden dropout of
// `_mlp_dropout_kernel` from `bits` (m, hdim), threshold `thr`, factor
// `keep_scale`.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2,
                 const uint16_t* __restrict__ bits, bf16* __restrict__ y,
                 int m, int kdim, int hdim, int thr, float keep_scale) {
  constexpr int N = 64 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = kdim + 8;
  bf16* sX = reinterpret_cast<bf16*>(smem);  // BM x ldk
  bf16* sW1 = sX + BM * ldk;                 // HC x ldk: rows c..c+HC of W1
  bf16* sW2 = sW1 + HC * ldk;                // N x LDH: columns c..c+HC of W2
  bf16* sH = sW2 + N * LDH;                  // BM x LDH: the bf16 hidden chunk
  float* sR = reinterpret_cast<float*>(sH + BM * LDH);  // WARPS x BM x LDR
  uint16_t* sB = reinterpret_cast<uint16_t*>(sR + WARPS * BM * LDR);  // BM x LDB

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // group 1: x, the first W1 chunk (and its bits); group 2: the first W2
  // chunk
  load_block_async(sX, ldk, x + (size_t)m0 * kdim, kdim, BM, kdim, m - m0);
  load_block_async(sW1, ldk, w1, kdim, HC, kdim, HC);
  load_block_async(sB, LDB, bits + (size_t)m0 * hdim, hdim, BM, HC, m - m0);
  cp_async_commit();
  load_block_async(sW2, LDH, w2, hdim, N, HC, N);
  cp_async_commit();

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int c = 0; c < hdim; c += HC) {
    const bool more = c + HC < hdim;
    cp_async_wait<1>();  // W1 chunk c, its bits (and x) landed; W2 chunk c may not have
    __syncthreads();

    // this warp's partial of the 32 x 32 chunk x . W1[c..c+HC]^T, over the
    // 16-wide k steps warp, warp + 8, ...
    float p[2][HC / 8][4] = {};
    for (int ks = warp; ks < kdim / 16; ks += WARPS) {
      const int col = ks * 16 + 2 * t;
      uint32_t a[2][4];
      load_a(a[0], sX, ldk, g, col);
      load_a(a[1], sX, ldk, 16 + g, col);
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const bf16* w1row = sW1 + (j * 8 + g) * ldk;
        const uint32_t b[2] = {emm::ld32(w1row + col), emm::ld32(w1row + col + 8)};
        emm::mma_16816(p[0][j], a[0], b);
        emm::mma_16816(p[1][j], a[1], b);
      }
    }
    float* part = sR + warp * BM * LDR;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const int r = i * 16 + g, col = j * 8 + 2 * t;
        *reinterpret_cast<float2*>(part + r * LDR + col) = make_float2(p[i][j][0], p[i][j][1]);
        *reinterpret_cast<float2*>(part + (r + 8) * LDR + col) =
            make_float2(p[i][j][2], p[i][j][3]);
      }
    __syncthreads();

    // sum the 8 partials, bias, gelu, [dropout,] round: 4 hidden values a
    // thread
    {
      const int r = threadIdx.x / (HC / 4), col = (threadIdx.x % (HC / 4)) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(sR + (w * BM + r) * LDR + col);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const float4 bias = *reinterpret_cast<const float4*>(b1 + c + col);
      float4 h = make_float4(gelu_tanh(s.x + bias.x), gelu_tanh(s.y + bias.y),
                             gelu_tanh(s.z + bias.z), gelu_tanh(s.w + bias.w));
      uint2 bv = *reinterpret_cast<const uint2*>(sB + r * LDB + col);
      bv.x ^= 0x80008000u;  // int16 u - 32768 -> uint16 u
      bv.y ^= 0x80008000u;
      h.x = (bv.x & 0xFFFFu) >= (unsigned)thr ? h.x * keep_scale : 0.f;
      h.y = (bv.x >> 16) >= (unsigned)thr ? h.y * keep_scale : 0.f;
      h.z = (bv.y & 0xFFFFu) >= (unsigned)thr ? h.z * keep_scale : 0.f;
      h.w = (bv.y >> 16) >= (unsigned)thr ? h.w * keep_scale : 0.f;
      const uint2 hv = make_uint2(emm::pack_bf16(h.x, h.y), emm::pack_bf16(h.z, h.w));
      *reinterpret_cast<uint2*>(sH + r * LDH + col) = hv;
    }
    cp_async_wait<0>();  // W2 chunk c landed
    __syncthreads();     // h is whole; no warp reads the W1 chunk, its bits or sR any more
    if (more) {
      load_block_async(sW1, ldk, w1 + (size_t)(c + HC) * kdim, kdim, HC, kdim,
                       HC);
      load_block_async(sB, LDB, bits + (size_t)m0 * hdim + c + HC, hdim, BM, HC, m - m0);
    }
    cp_async_commit();

    // acc (32 rows x N/8 outputs) += h . W2[:, c..c+HC]^T
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      const int col = kk + 2 * t;
      uint32_t a[2][4];
      load_a(a[0], sH, LDH, g, col);
      load_a(a[1], sH, LDH, 16 + g, col);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* w2row = sW2 + (warp * (N / 8) + j * 8 + g) * LDH;
        const uint32_t b[2] = {emm::ld32(w2row + col), emm::ld32(w2row + col + 8)};
        emm::mma_16816(acc[0][j], a[0], b);
        emm::mma_16816(acc[1][j], a[1], b);
      }
    }
    __syncthreads();  // no warp reads h or the W2 chunk any more
    if (more) load_block_async(sW2, LDH, w2 + c + HC, hdim, N, HC, N);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + i * 16 + g + 8 * hh;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = warp * (N / 8) + j * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[i][j][2 * hh] + b2[col],
                                  acc[i][j][2 * hh + 1] + b2[col + 1]);
      }
    }
}

template <int NT>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* bits, void* y, int m, int kdim, int hdim,
           int thr, float keep_scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * ((size_t)(BM + HC) * (kdim + 8) + (size_t)(64 * NT + BM) * LDH) +
      sizeof(float) * WARPS * BM * LDR + sizeof(uint16_t) * BM * LDB;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mlp_kernel<NT><<<(m + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const uint16_t*>(bits),
      static_cast<bf16*>(y), m, kdim, hdim, thr, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, kdim) bf16; w1: (hdim, kdim) bf16; b1: (hdim) fp32; w2: (ndim, hdim)
// bf16; b2: (ndim) fp32; y: (m, ndim) bf16; all contiguous. kdim % 16 == 0,
// hdim % 32 == 0, ndim == 768 (VLMo-Base). The hidden dropout of
// `_mlp_dropout_kernel`:
// bits: (m, hdim) int16 holding u - 32768 for uint16 draws u, contiguous;
// an element is kept where u >= threshold (0 < threshold < 65536) and then
// scaled by keep_scale = 65536 / (65536 - threshold).
extern "C" int fused_mlp_fwd_drop(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* bits,
                                  void* y, int m, int kdim, int hdim, int ndim,
                                  int threshold, float keep_scale, void* stream) {
  if (m <= 0 || kdim <= 0 || kdim % 16 != 0 || hdim <= 0 || hdim % HC != 0 ||
      ndim != 768 || threshold <= 0 || threshold >= 65536)
    return cudaErrorInvalidValue;
  return launch<12>(x, w1, b1, w2, b2, bits, y, m, kdim, hdim, threshold,
                          keep_scale, static_cast<cudaStream_t>(stream));
}
