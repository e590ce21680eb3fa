// K2: int8 x int8 -> int32 GEMM with an optional dequant epilogue.
//
// Replaces matmul_int8_pallas (lbt_tpu/ops/pallas/quant_kernels.py,
// _mm_int8_kernel): C[M,N] = A[M,K] @ B[K,N] over int8 codes, accumulated
// exactly in int32, then either stored raw (int32) or as (float)acc *
// inv_scale (f32), inv_scale = 1 / (mult_x * mult_w) read from device
// memory.  A and B are row-major and contiguous.
//
// What bounds it on an H100: the serving shapes are tall and thin (M up
// to 131072 rows of im2col patches, K = 16..576, N = 10..64), so the
// kernel streams A once and is bound by bytes, not by the int8 tensor
// cores.  This first version is a plain shared-memory tiled kernel:
//   * the N tile matches the layer width (16, 32 or 64 columns) so thin
//     layers do not idle most threads, and the M tile grows to keep
//     4096 outputs (16 per thread) per block;
//   * A and B stages of BK = 32 bytes of K are packed four codes to a
//     32-bit word in shared memory (B transposed on the way in), and each
//     thread runs __dp4a (4 int8 products summed into an int32) on a 4x4
//     register tile;
//   * ragged M, N and K are masked here, where the TPU kernel padded every
//     dim to 128 in device memory (quant_kernels.py:180-184): K = 27 at
//     the stem, N = 10 at the head.
// mma.sync / wgmma tensor-core tiles and TMA pipelines are later work.
//
// The X^T.g form (lbt_int8_gemm_tn) is the weight gradient of training:
// C[M,N] = A[K,M]^T @ B[K,N], A read transposed, where K = B*Ho*Wo rows of
// im2col patches reaches 131072 at ResNet-20's first stage while M x N is
// at most 576 x 64.  The output is too small to fill the card, so K is
// split over the grid's z dimension: each block sums a chunk of at most
// 2^16 rows exactly in int32 (|a*b| <= 2^14) and adds its partial into an
// int64 output with atomicAdd.  Integer addition is associative, so the
// result does not depend on the order the blocks run in; an int64 sum
// cannot wrap where the exact int32 one would (2^17 rows x 2^14).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lbt_tpu_torch/ops/kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;          // K bytes per shared-memory stage
constexpr int kKQ = kBK / 4;     // packed 32-bit words per row of a stage
constexpr int kTM = 4;           // outputs per thread along M
constexpr int kTN = 4;           // outputs per thread along N

template <int BN, bool kVecA>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 void* __restrict__ out, const float* __restrict__ inv_scale,
                 int m, int n, int k) {
  constexpr int kNT = BN / kTN;          // threads along N
  constexpr int kMT = kThreads / kNT;    // threads along M
  constexpr int kBM = kMT * kTM;
  // +1 word of padding per row keeps the column reads conflict-free
  __shared__ int32_t as[kBM][kKQ + 1];
  __shared__ int32_t bs[BN][kKQ + 1];

  const int tid = threadIdx.x;
  const int tx = tid % kNT;
  const int ty = tid / kNT;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;

  int32_t acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A stage: kBM rows x kKQ words, four consecutive k per word
    for (int i = tid; i < kBM * kKQ; i += kThreads) {
      const int r = i / kKQ;
      const int q = i % kKQ;
      const int64_t row = m0 + r;
      const int kk = k0 + 4 * q;
      uint32_t w = 0;
      if (row < m && kk < k) {
        const int8_t* p = a + row * k + kk;
        if (kVecA) {  // k % 4 == 0 and A 4-byte aligned: kk + 3 < k
          w = *reinterpret_cast<const uint32_t*>(p);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (kk + t < k)
              w |= static_cast<uint32_t>(static_cast<uint8_t>(p[t]))
                   << (8 * t);
        }
      }
      as[r][q] = static_cast<int32_t>(w);
    }
    // B stage, transposed: BN columns x kKQ words
    for (int i = tid; i < BN * kKQ; i += kThreads) {
      const int c = i % BN;
      const int q = i / BN;
      const int col = n0 + c;
      const int kk = k0 + 4 * q;
      uint32_t w = 0;
      if (col < n) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (kk + t < k)
            w |= static_cast<uint32_t>(static_cast<uint8_t>(
                     b[static_cast<int64_t>(kk + t) * n + col]))
                 << (8 * t);
      }
      bs[c][q] = static_cast<int32_t>(w);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kKQ; ++q) {
      int32_t av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[ty + i * kMT][q];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[tx + j * kNT][q];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float scale = inv_scale != nullptr ? *inv_scale : 0.0f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = m0 + ty + i * kMT;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + j * kNT;
      if (col >= n) continue;
      const int64_t idx = row * n + col;
      if (inv_scale != nullptr) {
        static_cast<float*>(out)[idx] =
            __int2float_rn(acc[i][j]) * scale;
      } else {
        static_cast<int32_t*>(out)[idx] = acc[i][j];
      }
    }
  }
}

template <int BN>
cudaError_t launch(const int8_t* a, const int8_t* b, void* out,
                   const float* inv_scale, int m, int n, int k,
                   cudaStream_t stream) {
  constexpr int kBM = (kThreads / (BN / kTN)) * kTM;
  const dim3 grid((m + kBM - 1) / kBM, (n + BN - 1) / BN);
  const bool vec_a =
      k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  if (vec_a) {
    int8_gemm_kernel<BN, true><<<grid, kThreads, 0, stream>>>(
        a, b, out, inv_scale, m, n, k);
  } else {
    int8_gemm_kernel<BN, false><<<grid, kThreads, 0, stream>>>(
        a, b, out, inv_scale, m, n, k);
  }
  return cudaGetLastError();
}

// C[M,N] += A[K,M]^T @ B[K,N] over rows [z*chunk, (z+1)*chunk) of K
template <int BN>
__global__ void __launch_bounds__(kThreads)
int8_gemm_tn_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    unsigned long long* __restrict__ out, int m, int n, int k,
                    int chunk) {
  constexpr int kNT = BN / kTN;
  constexpr int kMT = kThreads / kNT;
  constexpr int kBM = kMT * kTM;
  __shared__ int32_t as[kBM][kKQ + 1];
  __shared__ int32_t bs[BN][kKQ + 1];

  const int tid = threadIdx.x;
  const int tx = tid % kNT;
  const int ty = tid / kNT;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(k, kbeg + chunk);

  int32_t acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    // A stage: column m0+r of A (a row of A^T), four k per word; threads
    // adjacent in r read adjacent bytes of one row of A
    for (int i = tid; i < kBM * kKQ; i += kThreads) {
      const int r = i % kBM;
      const int q = i / kBM;
      const int col = m0 + r;
      const int kk = k0 + 4 * q;
      uint32_t w = 0;
      if (col < m) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (kk + t < kend)
            w |= static_cast<uint32_t>(static_cast<uint8_t>(
                     a[static_cast<int64_t>(kk + t) * m + col]))
                 << (8 * t);
      }
      as[r][q] = static_cast<int32_t>(w);
    }
    for (int i = tid; i < BN * kKQ; i += kThreads) {
      const int c = i % BN;
      const int q = i / BN;
      const int col = n0 + c;
      const int kk = k0 + 4 * q;
      uint32_t w = 0;
      if (col < n) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (kk + t < kend)
            w |= static_cast<uint32_t>(static_cast<uint8_t>(
                     b[static_cast<int64_t>(kk + t) * n + col]))
                 << (8 * t);
      }
      bs[c][q] = static_cast<int32_t>(w);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kKQ; ++q) {
      int32_t av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[ty + i * kMT][q];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[tx + j * kNT][q];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty + i * kMT;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + j * kNT;
      if (col >= n || acc[i][j] == 0) continue;
      atomicAdd(out + static_cast<int64_t>(row) * n + col,
                static_cast<unsigned long long>(
                    static_cast<long long>(acc[i][j])));
    }
  }
}

constexpr int kMaxChunk = 1 << 16;  // rows per block: exact in int32
constexpr int kTargetBlocks = 4 * 132;

template <int BN>
cudaError_t launch_tn(const int8_t* a, const int8_t* b,
                      unsigned long long* out, int m, int n, int k,
                      cudaStream_t stream) {
  constexpr int kBM = (kThreads / (BN / kTN)) * kTM;
  const int mt = (m + kBM - 1) / kBM;
  const int nt = (n + BN - 1) / BN;
  // enough K splits to give the card ~4 blocks per SM, in whole stages
  int splits = (kTargetBlocks + mt * nt - 1) / (mt * nt);
  int chunk = (k + splits - 1) / splits;
  chunk = ((chunk + kBK - 1) / kBK) * kBK;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  splits = (k + chunk - 1) / chunk;
  const dim3 grid(mt, nt, splits);
  int8_gemm_tn_kernel<BN><<<grid, kThreads, 0, stream>>>(a, b, out, m, n, k,
                                                        chunk);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  out is float32 when inv_scale is non-null,
// int32 otherwise.  Requires m, n, k >= 1.  Returns cudaGetLastError()
// after the launch (0 = cudaSuccess).
extern "C" int lbt_int8_gemm(const void* a, const void* b, void* out,
                             const void* inv_scale, int m, int n, int k,
                             void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* s = static_cast<const float*>(inv_scale);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= 16) {
    err = launch<16>(a8, b8, out, s, m, n, k, st);
  } else if (n <= 32) {
    err = launch<32>(a8, b8, out, s, m, n, k, st);
  } else {
    err = launch<64>(a8, b8, out, s, m, n, k, st);
  }
  return static_cast<int>(err);
}

// C interface: out[M,N] (int64, zeroed by the caller) += A[K,M]^T @ B[K,N].
// Requires m, n, k >= 1 and k / 2^16 splits within the grid's z limit.
extern "C" int lbt_int8_gemm_tn(const void* a, const void* b, void* out,
                                int m, int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  auto* o = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= 16) {
    err = launch_tn<16>(a8, b8, o, m, n, k, st);
  } else if (n <= 32) {
    err = launch_tn<32>(a8, b8, o, m, n, k, st);
  } else {
    err = launch_tn<64>(a8, b8, o, m, n, k, st);
  }
  return static_cast<int>(err);
}
