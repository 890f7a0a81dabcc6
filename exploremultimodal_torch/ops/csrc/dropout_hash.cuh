// Attention-dropout keep mask, bit-identical to the JAX package's in-kernel
// hash (exploremultimodal_tpu/ops/flash_attention.py `_dropout_keys` :88,
// `_dropout_bits` :70, `_keep_mask` :97). The mask is a pure function of
// (seed, batch*head, query row, key column), so the backward regenerates the
// forward's mask and it never reaches device memory. The batch*head is the
// head's index in JAX's global batch (`dropout_head`): a process that runs
// its share of the batch passes each row's global index, and one that holds
// a share of the heads passes their offset and the heads' total. All arithmetic is
// uint32 with wraparound, as in the JAX kernels.
#pragma once

#include <stdint.h>

namespace emm {

struct DropKeys {
  uint32_t k0, k1;
};

__device__ __forceinline__ DropKeys dropout_keys(int32_t seed, int bh) {
  const uint32_t s = static_cast<uint32_t>(seed);
  const uint32_t b = static_cast<uint32_t>(bh);
  return {(s ^ (b * 0x9E3779B9u)) | 1u, (s * 0x85EBCA6Bu) ^ (b + 0x165667B1u)};
}

// The batch*head that keys head `bh` of a call of `heads` heads a row:
// (row_index ? row_index[b] : b) * heads_total + head0 + h, b = bh / heads,
// h = bh % heads. A rank that holds heads head0 .. head0 + heads - 1 of the
// `heads_total` heads of each row (tensor parallelism) keys them by their
// global index; with heads_total = heads and head0 = 0 it is bh itself
// without a row index, else the head's index in the global batch. Read once
// per head, for the key only; nothing is addressed by it.
__device__ __forceinline__ int dropout_head(const int32_t* row_index, int bh, int heads,
                                            int heads_total, int head0) {
  const int b = bh / heads, h = bh % heads;
  return (row_index == nullptr ? b : row_index[b]) * heads_total + head0 + h;
}

// counter = row * 2^16 + col, avalanched by three murmur rounds
__device__ __forceinline__ uint32_t dropout_bits(DropKeys key, int row,
                                                 int col) {
  uint32_t x = static_cast<uint32_t>(row) * 65536u + static_cast<uint32_t>(col);
  x ^= key.k0;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x ^= key.k1;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x27D4EB2Fu;
  x ^= x >> 15;
  return x;
}

// the inverted-dropout factor of one (row, col): `scale` where kept, else 0
__device__ __forceinline__ float dropout_keep(DropKeys key, int row, int col,
                                              uint32_t threshold,
                                              float scale) {
  return dropout_bits(key, row, col) >= threshold ? scale : 0.f;
}

}  // namespace emm
