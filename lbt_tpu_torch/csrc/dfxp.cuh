// Device helpers shared by the port's DFXP kernels (quantize.cu and
// conv_fused.cu): lbt_tpu's counter-hash noise and the order-preserving
// integer keys their min/max atomics use.  build.py hashes this header
// with every source, so a change rebuilds both libraries.

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
