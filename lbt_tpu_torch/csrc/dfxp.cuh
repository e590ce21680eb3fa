// Device helpers shared by the port's DFXP kernels (quantize.cu and
// conv_fused.cu): lbt_tpu's three stochastic-rounding noise streams (the
// counter hashes and jax.random's threefry uniforms), the counter of a
// draw shared along axis 0, and the order-preserving integer keys their
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

// Noise modes: 1 the hash (lowbias32), 2 hash1, 3 threefry; k0 is the
// hashes' seed or the threefry key's first word, k1 its second.
__device__ __forceinline__ float noise_uniform(int mode, unsigned int idx,
                                               unsigned int k0,
                                               unsigned int k1) {
  if (mode == 3) return threefry_uniform(k0, k1, idx);
  return hash_uniform(idx, k0, mode == 2);
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
