// Kernels #4 and #5 (the fused int8 conv + DFXP epilogue) in noise modes
// 0-2 (none, hash, hash1): the entry points.  The design, the kernels and
// their launch are in conv_fused.cuh; mode 3's entry points, with the same
// C interface and names ending in _threefry, in conv_fused_threefry.cu,
// mode 4's (_rbg) in conv_fused_rbg.cu.

#include "conv_fused.cuh"

// C interface for ctypes.  x: int8 or (x_int16 != 0) int16 NHWC codes;
// w: int8 HWIO codes; codes: int8 [b, ho, wo, cout] out; moments: int64
// [2*cout + 2], zeroed by the caller ([sum q; sum q^2], then one slot of
// min/max keys and one of the blocks' ticket counter); minmax: float [2]
// out; inv_scale, mult: one float each on the device; mode 0 rounds half
// to even, 1-4 stochastically (hash, hash1, threefry, Philox; dfxp.cuh)
// with the key words k0 (the hashes' seed), k1, k2 and k3 (Philox's), at
// the counter idx + offset, or
// idx % inner when inner > 0 (which must then be ho*wo*n_global, with
// offset 0), idx the flat NHWC index with rows n_global wide and this
// call's channels at columns col0.. (n_global = 0: rows cout wide, col0
// 0); round_bf16 != 0 rounds the conv output to bfloat16 before min/max
// and the quantize.  One launch; returns cudaGetLastError() after
// it.
extern "C" int lbt_conv3x3_fused(
    const void* x, int x_int16, const void* w, void* codes, void* moments,
    void* minmax, const void* inv_scale, const void* mult, unsigned int k0,
    unsigned int k1, unsigned int k2, unsigned int k3, unsigned int inner,
    unsigned int offset, unsigned int n_global, unsigned int col0, int mode,
    int round_bf16, int bits_out, const int* dims, void* stream) {
  return entry<3, 3, 0>(x, x_int16, w, codes, moments, minmax,
                        inv_scale, mult, k0, k1, k2, k3, inner, offset,
                        n_global, col0, mode, round_bf16, bits_out, dims,
                        stream);
}

extern "C" int lbt_conv1x1_fused(
    const void* x, int x_int16, const void* w, void* codes, void* moments,
    void* minmax, const void* inv_scale, const void* mult, unsigned int k0,
    unsigned int k1, unsigned int k2, unsigned int k3, unsigned int inner,
    unsigned int offset, unsigned int n_global, unsigned int col0, int mode,
    int round_bf16, int bits_out, const int* dims, void* stream) {
  return entry<1, 1, 0>(x, x_int16, w, codes, moments, minmax,
                        inv_scale, mult, k0, k1, k2, k3, inner, offset,
                        n_global, col0, mode, round_bf16, bits_out, dims,
                        stream);
}
