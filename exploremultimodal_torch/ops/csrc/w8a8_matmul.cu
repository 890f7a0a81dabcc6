// W8A8 matmul for Hopper (sm_90a): y = dequant(row_quant(x) . qw^T)
//
// Replaces the Pallas kernel `_fused_kernel`
// (exploremultimodal_tpu/ops/quant_pallas.py:48, launched by
// `_fused_w8a8_padded` :84). Same function and rounding: every row of the
// bf16 x (M, 768) gets its own scale s = max(absmax, 1e-8) * (1/127) and
// codes rint(x * (1/s)) clipped to +-127 (round half to even, as
// jnp.round); the int8 product with the weight codes qw (N, 768, nn.Linear's
// layout) is summed exactly in int32; the epilogue is (float(acc) * s) *
// sw[n], rounded once to bf16. Every product is __fmul_rn, so no FMA
// contraction moves a scale or a dequantized value. As in the TPU kernel,
// the block quantizes its rows itself, into shared memory: the int8 copy of
// x never reaches device memory.
//
// What bounds it on an H100: at the VLMo-Base shapes (qkv N = 2304, proj
// N = 768, M up to 64 * 237 rows) it does 2*M*N*768 int8 operations against
// 2 bytes per element of x and y: about 230 operations per byte at N = 768,
// where the int8 tensor cores (1979 TOP/s) and memory (3.35 TB/s) cost
// about the same; at qkv's shape bytes and operations are within 5%.
//
// Design (simple first):
//   - a block of 8 warps owns BM = 64 rows: it quantizes them into shared
//     memory (one warp per row) and keeps the codes for all its output
//     tiles, as the TPU kernel keeps them across its inner n sweep;
//   - it walks its output tiles of BN = 64 columns, and each tile's weight
//     codes in slices of 256 bytes of K, through a 3-stage cp.async ring
//     (three 17 KB slices), so the next slices load while one is multiplied;
//   - each warp owns a 32 x 16 piece of the tile: mma.sync m16n8k32 (s8 in,
//     s32 accumulate), 16 accumulators a thread;
//   - 100 KB of shared memory lets two blocks share an SM; where the row
//     blocks alone fill fewer than two per SM (M = 2,560), the output
//     columns are split over blockIdx.y, each such block quantizing its
//     rows again.
// With mma.sync every operand passes through registers and each k step
// reads 384 bytes of fragments from shared memory per product, which bounds
// this design below the tensor cores' rate; wgmma with TMA is later work.

#include <algorithm>

#include "int8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int K = 768;        // the input width this kernel is built for
constexpr int BM = 64;        // rows per block
constexpr int BN = 64;        // output columns per tile
constexpr int KC = 256;       // bytes of K per ring slice
constexpr int KCH = K / KC;   // slices per output tile
constexpr int STAGES = 3;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDX = K + 16;   // smem pitch (bytes) of the x codes: rows 4 banks apart
constexpr int LDW = KC + 16;  // smem pitch of a weight slice: rows 4 banks apart
constexpr size_t SMEM = (size_t)BM * LDX + (size_t)STAGES * BN * LDW + BM * sizeof(float);

// starts loading bytes kc*KC .. of output rows n0 .. n0+BN-1 of qw (n, K)
__device__ __forceinline__ void load_slice(int8_t* dst, const int8_t* qw, int n0, int kc) {
  i8::load_rows_async(dst, LDW, qw + (size_t)n0 * K + kc * KC, K, BN, KC, BN);
}

__global__ void __launch_bounds__(THREADS, 2)
w8a8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ qw,
                   const float* __restrict__ sw, bf16* __restrict__ y, int m,
                   int n, int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sX = reinterpret_cast<int8_t*>(smem);  // BM x LDX codes of x
  int8_t* sW = sX + BM * LDX;                    // STAGES x BN x LDW weight slices
  float* sS = reinterpret_cast<float*>(sW + STAGES * BN * LDW);  // BM row scales

  const int m0 = blockIdx.x * BM;
  const int tile0 = blockIdx.y * tiles_per_block;
  const int iters = (min(n / BN, tile0 + tiles_per_block) - tile0) * KCH;
  if (iters <= 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // warp piece: rows wm*32.., columns wn*16..

  // the first slices start loading before the rows are quantized
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load_slice(sW + s * BN * LDW, qw, (tile0 + s / KCH) * BN, s % KCH);
    i8::cp_async_commit();
  }
  i8::quantize_rows<K>(x, m, m0, sX, LDX, sS, BM);

  int acc[2][2][4] = {};
  for (int it = 0; it < iters; ++it) {
    i8::cp_async_wait<STAGES - 2>();  // slice `it` landed
    __syncthreads();  // for every thread; the codes of x are written; slice it - 1 is free
    const int next = it + STAGES - 1;
    if (next < iters)
      load_slice(sW + (next % STAGES) * BN * LDW, qw, (tile0 + next / KCH) * BN, next % KCH);
    i8::cp_async_commit();

    const int8_t* slice = sW + (it % STAGES) * BN * LDW;
    const int kc = it % KCH;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      const int colw = ks * 32 + 4 * t;
      uint32_t a[2][4];
      i8::load_a(a[0], sX, LDX, wm * 32 + g, kc * KC + colw);
      i8::load_a(a[1], sX, LDX, wm * 32 + 16 + g, kc * KC + colw);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int8_t* wrow = slice + (wn * 16 + j * 8 + g) * LDW;
        const uint32_t b[2] = {i8::ld32(wrow + colw), i8::ld32(wrow + colw + 16)};
        i8::mma_16832(acc[0][j], a[0], b);
        i8::mma_16832(acc[1][j], a[1], b);
      }
    }
    if (kc != KCH - 1) continue;

    // the tile's last slice: dequantize, store, and start the next tile at 0
    const int tile = tile0 + it / KCH;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = wm * 32 + i * 16 + g + 8 * hh;
        if (m0 + rl >= m) continue;
        const float s = sS[rl];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = tile * BN + wn * 16 + j * 8 + 2 * t;
          const float2 w = *reinterpret_cast<const float2*>(sw + col);
          const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hh]), s), w.x);
          const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hh + 1]), s), w.y);
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + rl) * n + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  }
}

}  // namespace

// x: (m, 768) bf16; qw: (n, 768) int8; sw: (n) fp32; y: (m, n) bf16; all
// contiguous and 16-byte aligned; n % 64 == 0 (VLMo-Base's qkv 2304 and proj
// 768). Returns the launch's cudaError_t.
extern "C" int w8a8_matmul(const void* x, const void* qw, const void* sw, void* y,
                           int m, int n, void* stream) {
  if (m <= 0 || n <= 0 || n % BN != 0) return cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gx = (m + BM - 1) / BM, tiles = n / BN;
  // two blocks share an SM: split the columns while the row blocks alone
  // would leave slots empty
  const int split = std::max(1, std::min(tiles, 2 * sms / gx));
  const int per = (tiles + split - 1) / split;
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  w8a8_matmul_kernel<<<dim3(gx, (tiles + per - 1) / per), THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(sw), static_cast<bf16*>(y), m, n, per);
  return static_cast<int>(cudaGetLastError());
}
