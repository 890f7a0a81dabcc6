// W8A8 whole-MLP forward with hidden dropout for Hopper (sm_90a), on
// mma.sync:
//   y = dequant(row_quant(h) . qW2^T) + b2,
//   h = dropout(gelu_tanh(dequant(row_quant(x) . qW1^T) + b1))
//
// Replaces the Pallas kernel `_mlp_dropout_kernel`
// (exploremultimodal_tpu/ops/quant_pallas.py:366, launched by
// `_fused_mlp_dropout_padded` :399). The forward without dropout
// (`_mlp_kernel`) is w8a8_mlp_sm90.cu. Same function and rounding, step by
// step:
//   - each bf16 row of x gets its own scale s = max(absmax, 1e-8) * (1/127)
//     and codes rint(x * (1/s)) clipped to +-127 (half to even);
//   - the int8 product with the fp32 weights' codes qW1 (H, 768) is summed
//     exactly in int32, and h = (float(acc) * sx) * sw1 + b1 in fp32;
//   - the tanh-form gelu, 0.5 * h * (1 + tanh(0.79788... * (h + 0.044715 *
//     h * h * h))), in the order the Pallas kernel writes it;
//   - h is kept where the caller's uint16 bit u >= t and then
//     scaled by 65536 / (65536 - t), else 0, before the row absmax of h, as
//     at quant_pallas.py:377-379. The bits arrive as the int16 u - 32768 (the
//     port's storage of a draw), so the kernel flips each top bit to read u;
//   - each row of h is quantized over all H columns with its own scale sh;
//   - the int8 product with qW2 (768, H) is summed in int32, and y =
//     (float(acc) * sh) * sw2 + b2, rounded once to bf16.
// Every product and sum outside the tensor cores is __fmul_rn/__fadd_rn, so
// no FMA contraction moves a value.
//
// The row re-quantization decides the design: sh needs the absmax of the
// whole (BM, H) row of h before the second product may start, while a
// Hopper block cannot hold a (BM, 3072) fp32 hidden tile beside its
// weights at a useful BM. So the block makes two passes over the hidden:
//   pass 1  for each chunk of HC = 64 hidden columns: the first product, h,
//           and the running row absmax; h is thrown away;
//   pass 2  for each chunk: the first product again, h again (bit for bit
//           the same: int32 sums are exact in any order and the epilogue is
//           the same code), its codes at the now known sh into shared
//           memory, and the second product accumulated.
// That costs 1.5x the int8 operations of the two products.
//
// What bounds it on an H100: operations. At the VLMo-Base shapes (K = N =
// 768, H = 3072, M up to 64 * 237 rows) the two products are 2*M*(K*H +
// H*N) int8 operations against about 2*M*(K + N) bytes of activations
// (plus 2*M*H of bits) and 4.7 MB of weight codes: about 1000
// operations per byte, above the ~590 where the int8 tensor cores become
// the limit. The (M, H) hidden, 47 MB as int8 codes at M = 15,168, never
// reaches device memory.
//
// Design (simple first):
//   - a block of 8 warps owns BM = 32 rows; it quantizes them into shared
//     memory (one warp per row);
//   - first product: each warp owns a 16 x 16 piece of the 32 x 64 chunk
//     over all of K (mma.sync m16n8k32, s8 in, s32 accumulate), and its h
//     values stay in registers: their absmax (pass 1) or their codes into
//     shared memory (pass 2);
//   - second product: each warp owns 32 rows x 96 output columns of the
//     (32, 768) int32 accumulator, 96 registers a thread, as the bf16
//     kernel's fp32 one;
//   - chunks arrive by cp.async: in pass 1 the W1 chunks (and the bits)
//     alternate between two buffers, the second being pass 2's W2 buffer;
//     in pass 2 the W2 chunk loads while the first product runs, and the
//     next W1 chunk while the second runs.

#include "int8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int K = 768;        // input width
constexpr int N = 768;        // output width
constexpr int BM = 32;        // rows per block
constexpr int HC = 64;        // hidden columns per chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NT = N / 8 / WARPS;  // 8-column output tiles per warp (12)
constexpr int LDK = K + 16;   // smem pitch (bytes) of x codes and of a W1 chunk
constexpr int LDH = HC + 16;  // smem pitch (bytes) of a W2 chunk and of h codes
constexpr int LDB = HC + 8;   // smem pitch (uint16) of a bits tile

constexpr size_t X_BYTES = (size_t)BM * LDK;
constexpr size_t W1_BYTES = (size_t)HC * LDK;
constexpr size_t W2_BYTES = (size_t)N * LDH;
constexpr size_t H_BYTES = (size_t)BM * LDH;
constexpr size_t B_BYTES = (size_t)BM * LDB * sizeof(uint16_t);
constexpr size_t SMEM = X_BYTES + W1_BYTES + W2_BYTES + H_BYTES + 2 * B_BYTES +
                        7 * BM * sizeof(float);
static_assert(W2_BYTES >= W1_BYTES, "pass 1 keeps its second W1 buffer in the W2 one");

// one hidden value from its int32 sum: dequantize, bias, gelu, dropout
__device__ __forceinline__ float hidden(int acc, float sx, float sw1, float b1,
                                        uint16_t bits, int thr, float keep_scale) {
  const float h = i8::hidden(acc, sx, sw1, b1);
  return (bits ^ 0x8000u) >= static_cast<unsigned>(thr) ? __fmul_rn(h, keep_scale) : 0.f;
}

// this warp's 16 x 16 piece (rows wm*16.., chunk columns wn*16..) of the
// chunk's first product, over all of K
__device__ __forceinline__ void first_product(int acc[2][4], const int8_t* sX,
                                              const int8_t* sW1, int wm, int wn,
                                              int g, int t) {
#pragma unroll
  for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll 4
  for (int ks = 0; ks < K / 32; ++ks) {
    const int col = ks * 32 + 4 * t;
    uint32_t a[4];
    i8::load_a(a, sX, LDK, wm * 16 + g, col);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int8_t* wrow = sW1 + (wn * 16 + j * 8 + g) * LDK;
      const uint32_t b[2] = {i8::ld32(wrow + col), i8::ld32(wrow + col + 16)};
      i8::mma_16832(acc[j], a, b);
    }
  }
}

// Calls fn(hh, row, col, h0, h1) for the 8 hidden values this thread holds
// of the chunk at hidden column c, two at a time: h0, h1 at (row, col) and
// (row, col + 1), local to the block and the chunk; hh = 0 for the thread's
// row g, 1 for its row g + 8 of the warp's piece.
template <typename Fn>
__device__ __forceinline__ void for_hidden(int acc[2][4], int c, const float sx[2],
                                           const float* __restrict__ sw1,
                                           const float* __restrict__ b1,
                                           const uint16_t* sB, int wm, int wn, int g,
                                           int t, int thr, float keep_scale, Fn fn) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = wn * 16 + j * 8 + 2 * t;
    const float2 s = *reinterpret_cast<const float2*>(sw1 + c + col);
    const float2 b = *reinterpret_cast<const float2*>(b1 + c + col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = wm * 16 + g + 8 * hh;
      const uint32_t bits = *reinterpret_cast<const uint32_t*>(sB + row * LDB + col);
      const float h0 = hidden(acc[j][2 * hh], sx[hh], s.x, b.x, bits & 0xffffu, thr,
                              keep_scale);
      const float h1 = hidden(acc[j][2 * hh + 1], sx[hh], s.y, b.y, bits >> 16, thr,
                              keep_scale);
      fn(hh, row, col, h0, h1);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
w8a8_mlp_drop_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ qw1,
                const float* __restrict__ sw1, const float* __restrict__ b1,
                const int8_t* __restrict__ qw2, const float* __restrict__ sw2,
                const float* __restrict__ b2, const uint16_t* __restrict__ bits,
                bf16* __restrict__ y, int m, int hdim, int thr, float keep_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sX = reinterpret_cast<int8_t*>(smem);  // BM x LDK codes of x
  int8_t* sW1 = sX + X_BYTES;                     // HC x LDK: rows c..c+HC of qW1
  int8_t* sW2 = sW1 + W1_BYTES;                   // N x LDH: columns c..c+HC of qW2
  int8_t* sH = sW2 + W2_BYTES;                    // BM x LDH: codes of the h chunk
  uint16_t* sB[2] = {reinterpret_cast<uint16_t*>(sH + H_BYTES),
                     reinterpret_cast<uint16_t*>(sH + H_BYTES + B_BYTES)};
  float* sSx = reinterpret_cast<float*>(sH + H_BYTES + 2 * B_BYTES);  // BM
  float* sSh = sSx + BM;                                              // BM
  float* sInvH = sSh + BM;                                            // BM
  float* sPart = sInvH + BM;  // 4 x BM: row absmax of h per column quarter

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // first-product piece
  const uint16_t* bits0 = bits + (size_t)m0 * hdim;

  auto load_w1 = [&](int8_t* dst, int c) {
    i8::load_rows_async(dst, LDK, qw1 + (size_t)c * K, K, HC, K, HC);
  };
  auto load_bits = [&](uint16_t* dst, int c) {
    i8::load_rows_async(dst, LDB * 2, bits0 + c, (size_t)hdim * 2, BM, HC * 2, m - m0);
  };

  // ---- pass 1: the row absmax of h -----------------------------------------
  int8_t* w1buf[2] = {sW1, sW2};
  load_w1(w1buf[0], 0);
  load_bits(sB[0], 0);
  i8::cp_async_commit();
  i8::quantize_rows<K>(x, m, m0, sX, LDK, sSx, BM);
  __syncthreads();
  const float sx[2] = {sSx[wm * 16 + g], sSx[wm * 16 + g + 8]};

  int acc1[2][4];
  float amax[2] = {0.f, 0.f};
  for (int c = 0, i = 0; c < hdim; c += HC, ++i) {
    if (c + HC < hdim) {
      load_w1(w1buf[(i + 1) & 1], c + HC);
      load_bits(sB[(i + 1) & 1], c + HC);
    }
    i8::cp_async_commit();
    i8::cp_async_wait<1>();  // chunk c landed
    __syncthreads();
    first_product(acc1, sX, w1buf[i & 1], wm, wn, g, t);
    for_hidden(acc1, c, sx, sw1, b1, sB[i & 1], wm, wn, g, t, thr, keep_scale,
                     [&](int hh, int, int, float h0, float h1) {
                       amax[hh] = fmaxf(amax[hh], fmaxf(fabsf(h0), fabsf(h1)));
                     });
    __syncthreads();  // no warp reads this chunk's buffers any more
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    amax[hh] = fmaxf(amax[hh], __shfl_xor_sync(0xffffffffu, amax[hh], 1));
    amax[hh] = fmaxf(amax[hh], __shfl_xor_sync(0xffffffffu, amax[hh], 2));
    if (t == 0) sPart[wn * BM + wm * 16 + g + 8 * hh] = amax[hh];
  }
  i8::cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    const float a = fmaxf(fmaxf(sPart[r], sPart[BM + r]), fmaxf(sPart[2 * BM + r], sPart[3 * BM + r]));
    i8::row_scale(a, sSh[r], sInvH[r]);
  }

  // ---- pass 2: h again, its codes, the second product ----------------------
  load_w1(sW1, 0);
  load_bits(sB[0], 0);
  i8::cp_async_commit();
  i8::load_rows_async(sW2, LDH, qw2, hdim, N, HC, N);
  i8::cp_async_commit();
  __syncthreads();  // the row scales of h are written
  const float inv[2] = {sInvH[wm * 16 + g], sInvH[wm * 16 + g + 8]};

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int c = 0; c < hdim; c += HC) {
    const bool more = c + HC < hdim;
    i8::cp_async_wait<1>();  // W1 chunk c and its bits landed; the W2 chunk may not have
    __syncthreads();
    first_product(acc1, sX, sW1, wm, wn, g, t);
    for_hidden(acc1, c, sx, sw1, b1, sB[0], wm, wn, g, t, thr, keep_scale,
                     [&](int hh, int row, int col, float h0, float h1) {
                       const uint32_t q0 = static_cast<uint32_t>(i8::quantize(h0, inv[hh]));
                       const uint32_t q1 = static_cast<uint32_t>(i8::quantize(h1, inv[hh]));
                       *reinterpret_cast<uint16_t*>(sH + row * LDH + col) =
                           static_cast<uint16_t>((q0 & 0xffu) | ((q1 & 0xffu) << 8));
                     });
    i8::cp_async_wait<0>();  // W2 chunk c landed
    __syncthreads();         // the h codes are whole; the W1 chunk and its bits are free
    if (more) {
      load_w1(sW1, c + HC);
      load_bits(sB[0], c + HC);
    }
    i8::cp_async_commit();

    // acc (32 rows x this warp's 96 outputs) += h codes . qW2[:, c..c+HC]^T
#pragma unroll
    for (int kk = 0; kk < HC; kk += 32) {
      const int col = kk + 4 * t;
      uint32_t a[2][4];
      i8::load_a(a[0], sH, LDH, g, col);
      i8::load_a(a[1], sH, LDH, 16 + g, col);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* wrow = sW2 + (warp * (N / WARPS) + j * 8 + g) * LDH;
        const uint32_t b[2] = {i8::ld32(wrow + col), i8::ld32(wrow + col + 16)};
        i8::mma_16832(acc[0][j], a[0], b);
        i8::mma_16832(acc[1][j], a[1], b);
      }
    }
    __syncthreads();  // no warp reads the h codes or the W2 chunk any more
    if (more) i8::load_rows_async(sW2, LDH, qw2 + c + HC, hdim, N, HC, N);
    i8::cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = i * 16 + g + 8 * hh;
      if (m0 + rl >= m) continue;
      const float s = sSh[rl];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = warp * (N / WARPS) + j * 8 + 2 * t;
        const float2 w = *reinterpret_cast<const float2*>(sw2 + col);
        const float2 b = *reinterpret_cast<const float2*>(b2 + col);
        const float v0 =
            __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hh]), s), w.x), b.x);
        const float v1 =
            __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hh + 1]), s), w.y), b.y);
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + rl) * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

}  // namespace

// x: (m, 768) bf16; qw1: (hdim, 768) int8; sw1, b1: (hdim) fp32; qw2: (768,
// hdim) int8; sw2, b2: (768) fp32; bits: (m, hdim) int16 holding u - 32768
// for uint16 draws u; y: (m, 768) bf16; all contiguous and 16-byte aligned;
// hdim % 64 == 0 (VLMo-Base: 3072). An element of the hidden is kept where
// u >= threshold (0 < threshold < 65536) and then scaled by keep_scale =
// 65536 / (65536 - threshold). Returns the launch's cudaError_t.
extern "C" int w8a8_mlp_fwd_drop(const void* x, const void* qw1, const void* sw1,
                                 const void* b1, const void* qw2, const void* sw2,
                                 const void* b2, const void* bits, void* y, int m,
                                 int hdim, int threshold, float keep_scale,
                                 void* stream) {
  if (m <= 0 || hdim <= 0 || hdim % HC != 0 || threshold <= 0 || threshold >= 65536)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_mlp_drop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  w8a8_mlp_drop_kernel<<<(m + BM - 1) / BM, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(qw1),
      static_cast<const float*>(sw1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(qw2), static_cast<const float*>(sw2),
      static_cast<const float*>(b2), static_cast<const uint16_t*>(bits),
      static_cast<bf16*>(y), m, hdim, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}
