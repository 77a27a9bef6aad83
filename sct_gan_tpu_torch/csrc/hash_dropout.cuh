// The dropout keep mask of the JAX package's default stream
// (sct_gan_tpu/ops/dropout.py::_hash_keep): a murmur3 finaliser over the flat
// element index plus a 32-bit seed. An element is kept iff its hash is at or
// above threshold = uint32(min(rate, 0.999999) * 2^32). All arithmetic is
// uint32 and wraps, as jnp.uint32 does, so the mask is bit for bit the one
// the JAX package (and the port's plain PyTorch version) draws.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t hash_bits(uint32_t index, uint32_t seed) {
  uint32_t h = (index + seed) * 0x9E3779B1u;
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ bool hash_keep(uint32_t index, uint32_t seed,
                                          uint32_t threshold) {
  return hash_bits(index, seed) >= threshold;
}

// Where one (b, h) head of an attention shard sits in the global (B, H) grid
// that keys its dropout mask: the shard's batch origin b0 and head origin h0
// among hg global heads (0, 0, H for an unsharded call). The flat index of
// weight (b, h, i, j) is then ((drop_head(b, h) * Sq + i) * Sk + j), mod 2^32.
struct DropShard {
  uint32_t b0, h0, hg;
};

__device__ __forceinline__ uint32_t drop_head(int b, int h, const DropShard& ds) {
  return ((uint32_t)b + ds.b0) * ds.hg + (uint32_t)h + ds.h0;
}
