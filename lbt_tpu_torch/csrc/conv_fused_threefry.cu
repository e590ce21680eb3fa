// Kernels #4 and #5 (the fused int8 conv + DFXP epilogue) in noise mode 3,
// jax.random.uniform's threefry (dfxp.cuh): the entry points, with the C
// interface of conv_fused.cu's (mode must be 3).  The design, the kernels
// and their launch are in conv_fused.cuh.  A source of its own, so that
// its kernels build in parallel with the other modes'
// (lbt_tpu_torch/ops/kernels/build.py).

#include "conv_fused.cuh"

extern "C" int lbt_conv3x3_fused_threefry(
    const void* x, int x_int16, const void* w, void* codes, void* moments,
    void* minmax, const void* inv_scale, const void* mult, unsigned int k0,
    unsigned int k1, unsigned int k2, unsigned int k3, unsigned int inner,
    unsigned int offset, unsigned int n_global, unsigned int col0, int mode,
    int round_bf16, int bits_out, const int* dims, void* stream) {
  return entry<3, 3, 1>(x, x_int16, w, codes, moments, minmax,
                        inv_scale, mult, k0, k1, k2, k3, inner, offset,
                        n_global, col0, mode, round_bf16, bits_out, dims,
                        stream);
}

extern "C" int lbt_conv1x1_fused_threefry(
    const void* x, int x_int16, const void* w, void* codes, void* moments,
    void* minmax, const void* inv_scale, const void* mult, unsigned int k0,
    unsigned int k1, unsigned int k2, unsigned int k3, unsigned int inner,
    unsigned int offset, unsigned int n_global, unsigned int col0, int mode,
    int round_bf16, int bits_out, const int* dims, void* stream) {
  return entry<1, 1, 1>(x, x_int16, w, codes, moments, minmax,
                        inv_scale, mult, k0, k1, k2, k3, inner, offset,
                        n_global, col0, mode, round_bf16, bits_out, dims,
                        stream);
}
