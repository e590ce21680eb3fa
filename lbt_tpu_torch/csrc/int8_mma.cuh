// The int8 tensor-core building blocks that K2 (int8_gemm.cu), #4/#5
// (conv_fused.cuh) and the conv backward's dgrad and wgrad (conv_bwd.cu)
// share: cp.async staging, the mma.sync m16n8k32 s8 product, and the
// X^T.g form's ldmatrix .trans fragments with the shared-memory row
// stride they need.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously: the first `bytes` (0..16)
// from src, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 b16 matrices of shared memory, transposed (ldmatrix .trans):
// lane l gives the address of row l % 8 of matrix l / 8, a 16-byte row.
// Read as bytes, lane (g, t) = (l / 4, l % 4) gets in r[j] the bytes
// (2t, 2g), (2t, 2g+1), (2t+1, 2g), (2t+1, 2g+1) of matrix j's 8 rows x 16
// bytes.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The X^T.g form's fragments from K rows of 16-byte columns.  One
// ldsm_x4_trans over 32 K rows (lane l: row l) of 16 columns c0..c0+15
// and four prmt give lane (g, t) the k32 fragments of two 16-column
// halves: "even" words hold column c0 + 2g, "odd" words c0 + 2g + 1, each
// with the K rows 2t, 2t+1, 8+2t, 9+2t (bytes 0..3; 16 more in the second
// word).  Both operands take K in this order, so the contraction is the
// same sum; the output row of mma row g is m0 + 2g and of row g+8 m0 +
// 2g + 1, the output column of n8 tile 2q+o, column c, is 16q + 2c + o.
__device__ __forceinline__ int perm_row(int t, int e) {
  return 2 * t + (e & 1) + 8 * (e >> 1);
}

struct Frag16 {
  uint32_t even[2], odd[2];  // k 0..15 and 16..31 of columns 2g and 2g+1
};

__device__ __forceinline__ Frag16 frag16_ldsm(const unsigned char* rows,
                                              int stride, int c0, int lane) {
  uint32_t r[4];
  ldsm_x4_trans(r, rows + lane * stride + c0);
  return {{__byte_perm(r[0], r[1], 0x6420), __byte_perm(r[2], r[3], 0x6420)},
          {__byte_perm(r[0], r[1], 0x7531), __byte_perm(r[2], r[3], 0x7531)}};
}

// c += a (16x32, row) . b (32x8, col), int8 in, exact int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// the stride (bytes) of a staged X^T.g row of W bytes: an odd number of
// 16-byte chunks, so cp.async and ldmatrix rows stay aligned and the 8
// rows of an ldmatrix fall in 8 different bank groups
template <int W>
__host__ __device__ constexpr int tn_stride() {
  return (W / 16) % 2 == 1 ? W : W + 16;
}

}  // namespace
