// Device helpers shared by the port's DFXP kernels (quantize.cu and
// conv_fused.cu): lbt_tpu's stochastic-rounding noise streams (the counter
// hashes, jax.random's threefry uniforms, and its uniforms under an
// unsafe_rbg key: XLA's Philox4x32-10 stream), the counter of a draw
// shared along axis 0, and the order-preserving integer keys their
// min/max atomics use.  build.py hashes this header with every source, so
// a change rebuilds both libraries.

#pragma once

#include <cuda_runtime.h>

namespace {

// lbt_tpu's counter hash of idx ^ seed (lowbias32, or with light one
// multiply-xorshift round, hash1): the top 24 bits m of the uint32 hash,
// as m * 2^-24.  Built without an int-to-float conversion (16 a clock an
// SM): the low 23 bits of m as the mantissa of 1.f, minus 1 and halved,
// plus 0.5 for m's top bit.  Every step is exact, so u equals the plain
// version's (m as f32) * 2^-24.
__device__ __forceinline__ float hash_uniform(unsigned int idx,
                                              unsigned int seed, bool light) {
  unsigned int h = idx ^ seed;
  if (!light) h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  if (!light) h ^= h >> 16;
  const unsigned int m = h >> 8;
  const float f = __fsub_rn(__uint_as_float(0x3F800000u | (m & 0x7FFFFFu)),
                            1.0f);
  return __fmaf_rn(f, 0.5f, (m >> 23) ? 0.5f : 0.0f);
}

// jax.random.uniform(key, shape, float32) at flat index idx, with
// jax_threefry_partitionable on (JAX 0.9's default): the Threefry-2x32
// cipher (20 rounds, JAX's schedule and rotations) of the counter
// (hi32(idx), lo32(idx)) under the site key (k0, k1); the two output
// words xored, the top 23 bits as the mantissa of 1.f, minus 1.  At least
// 69 integer instructions an element (ops/kernels/work.py), against the
// hashes' 6-9: a kernel that draws it is bound by instruction issue, not
// bytes.
__device__ __forceinline__ unsigned int rotl32(unsigned int v, int r) {
  return __funnelshift_l(v, v, r);
}

__device__ __forceinline__ float threefry_uniform(unsigned int k0,
                                                  unsigned int k1,
                                                  unsigned long long idx) {
  const unsigned int ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  unsigned int x0 = static_cast<unsigned int>(idx >> 32) + ks[0];
  unsigned int x1 = static_cast<unsigned int>(idx) + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i % 2) ? 17 : 13, r1 = (i % 2) ? 29 : 15;
    const int r2 = (i % 2) ? 16 : 26, r3 = (i % 2) ? 24 : 6;
    x0 += x1; x1 = rotl32(x1, r0) ^ x0;
    x0 += x1; x1 = rotl32(x1, r1) ^ x0;
    x0 += x1; x1 = rotl32(x1, r2) ^ x0;
    x0 += x1; x1 = rotl32(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned int>(i + 1);
  }
  const unsigned int bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(bits), 1.0f);
}

// jax.random.uniform(key, shape, float32) under an unsafe_rbg key, as
// XLA's rng_bit_generator draws it off the TPU (the TPU's own hardware
// stream, which lbt_tpu's Pallas kernels draw, no card can give): the
// Philox4x32-10 stream.  Key data (k0, k1, k2, k3) is the state s0 = k0 |
// k1 << 32, s1 = k2 | k3 << 32; block b is the Philox4x32-10 block
// (Random123's rounds and constants) of the 128-bit counter (s0 << 64 |
// s1) + b, low word first, under the key (k0, k1); flat index i takes word
// i % 4 of block i / 4 (dfxp/keys.py:rbg_bits).  A round is two 32x32 ->
// 64-bit products (one IMAD.WIDE each) and two 3-input xors: 40 integer
// instructions a block, so 10 an element where one block serves the four
// consecutive elements it covers (ops/kernels/work.py), against threefry's
// 69.
__device__ __forceinline__ uint4 philox4x32_10(unsigned int k0,
                                               unsigned int k1, uint4 c) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned long long p0 =
        static_cast<unsigned long long>(c.x) * 0xD2511F53u;
    const unsigned long long p1 =
        static_cast<unsigned long long>(c.z) * 0xCD9E8D57u;
    c = make_uint4(static_cast<unsigned int>(p1 >> 32) ^ c.y ^ k0,
                   static_cast<unsigned int>(p1),
                   static_cast<unsigned int>(p0 >> 32) ^ c.w ^ k1,
                   static_cast<unsigned int>(p0));
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// An unsafe_rbg key's four words, and block b of its stream: the 128-bit
// counter's add with its carries, then the rounds
struct RbgKey {
  unsigned int k0, k1, k2, k3;
};

__device__ __forceinline__ uint4 rbg_block(const RbgKey& k, unsigned int b) {
  const unsigned long long lo =
      ((static_cast<unsigned long long>(k.k3) << 32) | k.k2) + b;
  const unsigned long long hi =
      ((static_cast<unsigned long long>(k.k1) << 32) | k.k0) + (lo < b);
  return philox4x32_10(
      k.k0, k.k1,
      make_uint4(static_cast<unsigned int>(lo),
                 static_cast<unsigned int>(lo >> 32),
                 static_cast<unsigned int>(hi),
                 static_cast<unsigned int>(hi >> 32)));
}

// a word of the stream as jax.random.uniform's float: the top 23 bits as
// the mantissa of 1.f, minus 1 (as threefry_uniform's last step)
__device__ __forceinline__ float bits_uniform(unsigned int w) {
  return __fsub_rn(__uint_as_float((w >> 9) | 0x3F800000u), 1.0f);
}

// the uniform of one flat index, its block drawn for it alone (where the
// four elements of a block are not one thread's: a window, a shared draw,
// an offset that is not a multiple of 4)
__device__ __forceinline__ float rbg_uniform(const RbgKey& k,
                                             unsigned int idx) {
  const uint4 r = rbg_block(k, idx >> 2);
  const unsigned int q = idx & 3u;
  return bits_uniform(q == 0 ? r.x : (q == 1 ? r.y : (q == 2 ? r.z : r.w)));
}

// The counter of flat index i: i + offset, or with SHARED (a draw of
// shape[1:] broadcast over axis 0, lbt_tpu's noise_shared_axis0, inner =
// prod(shape[1:])) (i + offset) % inner.  offset places a slice of rows
// in a larger tensor's draw: a rank that evaluates rows row0.. of a
// global batch draws at row0 * inner + i, as the global tensor would
// (0 otherwise).  WINDOW places a slice of columns: the tensor is read as
// rows of cols elements, columns col0.. of rows cols + gap wide, so
// element (r, j) first takes the counter r * (cols + gap) + col0 + j, the
// place its element has in the whole tensor (a tensor-parallel rank's
// slice of a weight).  SHARED and WINDOW are compile-time choices, so a
// draw without them pays nothing for them.  Counters stay below 2^32 in
// every caller.
template <bool SHARED, bool WINDOW = false>
__device__ __forceinline__ unsigned int noise_index(
    unsigned int i, unsigned int inner, unsigned int offset,
    unsigned int cols = 1u, unsigned int gap = 0u, unsigned int col0 = 0u) {
  if (WINDOW) i += (i / cols) * gap + col0;
  return SHARED ? (i + offset) % inner : i + offset;
}

// Noise modes: 1 the hash (lowbias32), 2 hash1, 3 threefry, 4 the
// unsafe_rbg key's Philox stream; k.k0 is the hashes' seed or the key's
// first word, k.k1 its second, k.k2 and k.k3 an unsafe_rbg key's others.
__device__ __forceinline__ float noise_uniform(int mode, unsigned int idx,
                                               const RbgKey& k) {
  if (mode == 4) return rbg_uniform(k, idx);
  if (mode == 3) return threefry_uniform(k.k0, k.k1, idx);
  return hash_uniform(idx, k.k0, mode == 2);
}

// float -> uint32 whose unsigned order is the float order (no NaN); 0 is
// below every key
__device__ __forceinline__ unsigned int ordered_key(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

}  // namespace
