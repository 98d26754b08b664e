// The counter-hash dropout stream shared by kernel 7 (csrc/fused_dropout.cu)
// and the attention-probs dropout branch of kernels 1-4 (csrc/flash_fwd*.cu,
// csrc/flash_bwd*.cu, csrc/flash_bwd_dlbias*.cu): the JAX package's
// `hw_rng=False` stream (ops/fused_dropout.py `_hash_bits`, `tile_keep`),
// bit for bit.
//
//   key  = mix32(seed * 0x9E3779B9 + tag_a * 0x85EBCA77 + tag_b * 0xC2B2AE3D)
//   bits = mix32(row * 0x27D4EB2F + col * 0x165667B1 + key)
//   keep = (bits >> 8) < T,   T = round((1 - rate) * 2^24)
//
// all in uint32 arithmetic; `mix32` is murmur3's finalizer.  An element's
// bits depend on its absolute (row, col) and not on any tiling, so a
// forward and a backward that tile a plane differently draw the same mask.
// Kernel 7's plane is the activation's 2-D view with tags (0, 0), and its
// wrapper passes `key`; the attention planes are (query, key) of head h of
// batch row b with tags (b, h), and kernels 1-4 form `key` per plane.
// (bits >> 8) < T is bits < T * 256 for T < 2^24, one compare.
// Each source that includes it gets its own copy (an anonymous namespace);
// ops/cuda_build.py hashes every csrc/*.cuh into each library's name.

#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t HASH_ROW_MUL = 0x27D4EB2Fu, HASH_COL_MUL = 0x165667B1u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// the word every element of the (seed, tag_a, tag_b) plane mixes in
__device__ __forceinline__ uint32_t stream_key(int seed, int tag_a, int tag_b) {
  return mix32((uint32_t)seed * 0x9E3779B9u + (uint32_t)tag_a * 0x85EBCA77u +
               (uint32_t)tag_b * 0xC2B2AE3Du);
}

// The probs dropout of kernels 1-4 as the C entries receive it: the int32
// seed, T, and the fp32 scale 1 / (1 - rate) that kept entries take.
// T = 2^24 is rate 0: every entry kept, and the entries run the instance
// without dropout.
struct ProbsDropout {
  int seed;
  uint32_t threshold;
  float inv_keep;
  __host__ __device__ bool on() const { return threshold < (1u << 24); }
};

// An entry's keep decision from its hash word (row and column terms plus
// the plane's key, before mixing), against T * 256.
__device__ __forceinline__ bool keep_word(uint32_t word, uint32_t thr8) {
  return mix32(word) < thr8;
}

}  // namespace
