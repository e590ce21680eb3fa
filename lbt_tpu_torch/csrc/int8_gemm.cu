// K2: int8 x int8 -> int32 GEMM on Hopper's int8 tensor cores, with an
// optional dequant epilogue, in two forms.
//
// Replaces matmul_int8_pallas (lbt_tpu/ops/pallas/quant_kernels.py,
// _mm_int8_kernel): C[M,N] = A[M,K] @ B[K,N] over int8 codes, accumulated
// exactly in int32, then either stored raw (int32) or as
// __int2float_rn(acc) * inv_scale (f32), inv_scale = 1 / (mult_x * mult_w)
// read from device memory.  A and B are row-major and contiguous.  The
// X^T.g form (lbt_int8_gemm_tn) is training's weight gradient:
// C[M,N] = A[K,M]^T @ B[K,N] summed exactly into int64.
//
// What bounds it on an H100: ResNet-20's products are tall and thin.  The
// AB form streams A (im2col'd activations or dilated cotangents, M up to
// 131072 rows, K = 10..576) against a B of at most 576 x 64 bytes; the
// X^T.g form streams A[K,M] (im2col'd split-9 planes, K = B*Ho*Wo up to
// 131072, M = 9*Cin up to 576) and B[K,N] (cotangent codes) into an
// output of at most 576 x 64.  A call does at most 2*M*N*K = 1.2 G int8
// ops against up to 27 MB of operand bytes: bound by bytes (3.35 TB/s: a
// stage-1 X^T.g call moves 21 MB, 6.3 us; a stage-1 AB call 27 MB, 8.1
// us), never by the 1,979 int8 TOP/s (ops/kernels/work.py counts both).
// The bytes counted are those of the im2col matrices the callers pass
// (lbt_tpu_torch/ops/qops.py: the forward of the unfused convs; the conv
// backward of convs whose channels are not multiples of 16, the others
// gathering their taps in conv_bwd.cu).  So the design is about moving A
// at the memory's rate:
//   * tensor cores: mma.sync m16n8k32 s8.s8.s32 (IMMA) warp tiles, each
//     warp one m16 tile against every n8 tile of the block's N, operands
//     K-major in registers as the instruction wants, shared-memory rows
//     padded so fragment loads do not conflict;
//   * staging: a cp.async pipeline of 16-byte copies (4 stages AB, 3
//     X^T.g), coalesced along the contiguous dimension,
//     cp.async.wait_group in place of a synchronous stage;
//   * ragged edges (K = 27 at the stem, 144, N = 10 at the head, ragged M)
//     are zero-filled in shared memory (cp.async with a short src-size,
//     or predicated loads), never padded in device memory.  Where whole
//     rows fit one stage (AB: K < 64, as K = 10, 16, 27, 32; X^T.g: M =
//     27, N = 10) a block's rows are one contiguous range, copied by
//     16-byte cp.async as it lies (row stride K in shared memory; the
//     bytes past a row's end meet zero rows of the other operand or
//     output rows that are dropped); word loads take about twice as long
//     at the stem's K = 27.  Other rows that are not 16-byte chunks take
//     aligned word loads and funnel shifts;
//   * AB form: 64 rows a block; B is transposed once per block into
//     shared memory (4x4 byte blocks: four word loads and prmt), while
//     A's first stages load; the N tile narrows (64 -> 32 -> 16) until
//     the grid holds two blocks per SM, so a stage-3 call (M = 8192)
//     fills the card as a stage-1 call (M = 131072, 2048 blocks) does;
//   * X^T.g form: A and B rows are copied 16 bytes at a time along M and
//     N (never one strided byte a word from device memory) into rows of
//     an odd number of 16-byte chunks.  The fragments come from those
//     M- or N-major rows by ldmatrix .trans (4 matrices of 8 K rows x 16
//     bytes) and prmt: lane (g, t) then holds columns 2g and 2g+1 at K
//     rows 2t, 2t+1, 8+2t, 9+2t, a fixed reordering of K that both
//     operands share, so the sum is unchanged; the output rows and
//     columns are permuted to match.  K is split over the grid's z
//     dimension (two blocks per SM, chunks of at most 768 rows where K
//     allows more blocks): each block sums its chunk (at most 2^16 rows)
//     exactly in int32 (|a*b| <= 2^14) and adds its partial into an int64
//     output with atomicAdd, the partials staged in shared memory first so
//     each warp's atomics cover consecutive addresses (scattered, they
//     were the form's largest cost).  Integer addition is associative, so
//     the result does not depend on the order the blocks run in; an int64
//     sum cannot wrap where the exact int32 one would (2^17 rows x 2^14).
// What still holds it back: not the operand bytes (with its loads
// replaced by zero-fills the X^T.g form keeps most of its time) but each
// block's chain of pipeline round trips (12 stages at stage 1) and the
// int64 atomics.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md, chip_smoke.py's
// K2-train rows): about 0.77 ms of a ResNet-20 training step at batch
// 128 (0.23 AB, 0.54 X^T.g) against a 0.24 ms bound; 2.28 ms before.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lbt_tpu_torch/ops/kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;         // K bytes (AB) or K rows (X^T.g) per stage
constexpr int kStagesAB = 4;    // cp.async pipeline depth, AB form
constexpr int kStages = 3;      // and X^T.g form
constexpr int kPad = 16;        // bytes of padding per shared-memory row
constexpr int kPanel = 1024;    // K bytes of B held in shared memory (AB)
constexpr int kBM = 16 * kWarps;  // rows (AB) or output rows (X^T.g) a
                                  // block: one m16 tile a warp
constexpr int kAS = kBK + kPad;   // AB: A stage row stride (80 B)

// the 4 bytes at p, at any alignment, from the two aligned words that
// hold them
__device__ __forceinline__ uint32_t ld32_any(const unsigned char* p) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  const auto* q = reinterpret_cast<const uint32_t*>(u & ~uintptr_t(3));
  return __funnelshift_r(q[0], q[1], 8 * static_cast<int>(u & 3));
}

// bytes [col, col + 4) of row `row` of a row-major [*, ld] int8 matrix at
// any alignment, from the aligned words that hold them; zero past ld
__device__ __forceinline__ uint32_t load_word(const int8_t* src, int64_t row,
                                              int ld, int col) {
  const int nb = ld - col;
  if (nb <= 0) return 0;
  const uintptr_t p = reinterpret_cast<uintptr_t>(src) + row * ld + col;
  const auto* q = reinterpret_cast<const uint32_t*>(p & ~uintptr_t(3));
  const int sh = static_cast<int>(p & 3);
  uint32_t w = q[0];
  if (sh != 0 && nb > 4 - sh) w = __funnelshift_r(w, q[1], 8 * sh);
  else if (sh != 0) w >>= 8 * sh;
  return nb >= 4 ? w : w & ((1u << (8 * nb)) - 1u);
}

// rows [kq, kq + plen) x columns [n0, n0 + BN) of a row-major [k, n] int8
// matrix into dst[BN][stride], transposed: four K bytes of one column a
// word; zero past k and n.  With n % 4 == 0 and b 4-byte aligned, each
// thread loads a 4x4 block as four words and transposes it with prmt.
template <int BN>
__device__ __forceinline__ void stage_b_t(unsigned char* dst, int stride,
                                          const int8_t* __restrict__ b, int n,
                                          int k, int n0, int kq, int plen,
                                          bool vec, int tid) {
  if (vec) {
    for (int i = tid; i < (BN / 4) * (plen / 4); i += kThreads) {
      const int c = 4 * (i % (BN / 4)), q = i / (BN / 4);
      const int col = n0 + c, kk = kq + 4 * q;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = (col < n && kk + e < k)
                   ? *reinterpret_cast<const uint32_t*>(
                         b + static_cast<int64_t>(kk + e) * n + col)
                   : 0u;
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      unsigned char* d = dst + c * stride + 4 * q;
      *reinterpret_cast<uint32_t*>(d) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(d + stride) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(d + 2 * stride) =
          __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(d + 3 * stride) =
          __byte_perm(t2, t3, 0x7632);
    }
  } else {
    for (int i = tid; i < BN * (plen / 4); i += kThreads) {
      const int c = i % BN, q = i / BN;
      const int col = n0 + c, kk = kq + 4 * q;
      uint32_t w = 0;
      if (col < n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kk + e < k)
            w |= static_cast<uint32_t>(static_cast<uint8_t>(
                     b[static_cast<int64_t>(kk + e) * n + col]))
                 << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(dst + c * stride + 4 * q) = w;
    }
  }
}

// frag16_ldsm's fragments (int8_mma.cuh) a byte at a time, for rows that
// are not 16-byte aligned (a flat copy of rows narrower than the tile)
__device__ __forceinline__ Frag16 frag16_bytes(const unsigned char* rows,
                                               int stride, int c0, int g,
                                               int t) {
  Frag16 f = {{0u, 0u}, {0u, 0u}};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned char* p = rows + (16 * h + perm_row(t, e)) * stride + c0;
      f.even[h] |= static_cast<uint32_t>(p[2 * g]) << (8 * e);
      f.odd[h] |= static_cast<uint32_t>(p[2 * g + 1]) << (8 * e);
    }
  return f;
}

// ---------------------------------------------------------------------------
// AB form: C[M,N] = A[M,K] @ B[K,N]
// ---------------------------------------------------------------------------

// FLAT (k < kBK, A 16-byte aligned): the block's rows are staged as one
// range, row stride k; otherwise vec_a picks 16-byte chunks or word loads.
// A template parameter, so the chunked path's loop keeps constant strides.
template <int BN, bool FLAT>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 void* __restrict__ out, const float* __restrict__ inv_scale,
                 int m, int n, int k, int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int panel = min(kPanel, (k + kBK - 1) / kBK * kBK);
  const int bstride = panel + kPad;
  unsigned char* bs = smem;                  // [BN][panel + 16], K-major
  unsigned char* as = smem + BN * bstride;   // [kStagesAB][kBM][kAS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;

  auto load_a = [&](int stage, int k0) {
    unsigned char* dst = as + stage * kBM * kAS;
    if (FLAT) {  // the block's rows are one aligned range of kBM * k
                 // bytes (64 k % 16 == 0), copied as it lies with row
                 // stride k and zero past it.  A row's bytes past k belong
                 // to the next row and meet B's zero rows past k.
      const int valid = (m - m0 < kBM ? static_cast<int>(m - m0) : kBM) * k;
      const int8_t* base = a + m0 * k;
      for (int i = tid; i < (kBM * k + 64) / 16; i += kThreads) {
        const int left = valid - 16 * i;
        cp_async16(dst + 16 * i, left > 0 ? base + 16 * i : a,
                   left > 0 ? min(16, left) : 0);
      }
    } else if (vec_a) {  // k % 16 == 0, A 16-byte aligned: chunks
      for (int i = tid; i < kBM * (kBK / 16); i += kThreads) {
        const int r = i / (kBK / 16), c = i % (kBK / 16);
        const int64_t row = m0 + r;
        const int kk = k0 + 16 * c;
        const bool ok = row < m && kk < k;
        cp_async16(dst + r * kAS + 16 * c, ok ? a + row * k + kk : a,
                   ok ? 16 : 0);
      }
    } else {  // rows of any length and alignment, a word at a time, all
              // of a thread's loads issued before its stores
      constexpr int kN = kBM * (kBK / 4) / kThreads;
      const int q = tid % (kBK / 4);
      uint32_t w[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int64_t row = m0 + tid / (kBK / 4) + j * (kThreads / (kBK / 4));
        w[j] = row < m ? load_word(a, row, k, k0 + 4 * q) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kN; ++j)
        *reinterpret_cast<uint32_t*>(
            dst + (tid / (kBK / 4) + j * (kThreads / (kBK / 4))) * kAS +
            4 * q) = w[j];
    }
  };

  int acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int kq = 0; kq < k; kq += panel) {
    const int plen = min(panel, (k - kq + kBK - 1) / kBK * kBK);
    const int nk = plen / kBK;
    __syncthreads();  // the last panel's fragments are read
#pragma unroll
    for (int s = 0; s < kStagesAB - 1; ++s) {
      if (s < nk) load_a(s, kq + s * kBK);
      cp_async_commit();
    }
    // B panel, transposed once while A's first stages are in flight
    stage_b_t<BN>(bs, bstride, b, n, k, n0, kq, plen, vec_b, tid);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStagesAB - 2>();
      __syncthreads();
      const int pf = kt + kStagesAB - 1;
      if (pf < nk) load_a(pf % kStagesAB, kq + pf * kBK);
      cp_async_commit();

      const int sa = FLAT ? k : kAS;  // the staged row stride
      const unsigned char* at =
          as + (kt % kStagesAB) * kBM * kAS + (warp * 16 + g) * sa + 4 * t;
      const unsigned char* bt = bs + g * bstride + kt * kBK + 4 * t;
      const int nsub = min(kBK / 32, (k - kq - kt * kBK + 31) / 32);
#pragma unroll
      for (int s = 0; s < kBK / 32; ++s) {
        if (s >= nsub) break;
        const int ko = 32 * s;
        uint32_t a0, a1, a2, a3;
        if (FLAT && k % 4 != 0) {  // rows at any alignment
          a0 = ld32_any(at + ko), a1 = ld32_any(at + 8 * sa + ko);
          a2 = ld32_any(at + ko + 16), a3 = ld32_any(at + 8 * sa + ko + 16);
        } else {
          a0 = ld32(at + ko), a1 = ld32(at + 8 * sa + ko);
          a2 = ld32(at + ko + 16), a3 = ld32(at + 8 * sa + ko + 16);
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const unsigned char* bp = bt + j * 8 * bstride + ko;
          mma_s8(acc[j], a0, a1, a2, a3, ld32(bp), ld32(bp + 16));
        }
      }
    }
  }

  // rows g and g+8 of the warp's m16 tile, columns 2t and 2t+1 of each n8
  const float scale = inv_scale != nullptr ? *inv_scale : 0.0f;
  const bool pair = n % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = m0 + warp * 16 + g + 8 * h;
      if (row >= m || col >= n) continue;
      const int64_t idx = row * n + col;
      const int v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      if (inv_scale != nullptr) {
        float* o = static_cast<float*>(out) + idx;
        const float f0 = __int2float_rn(v0) * scale;
        const float f1 = __int2float_rn(v1) * scale;
        if (pair) {
          *reinterpret_cast<float2*>(o) = make_float2(f0, f1);
        } else {
          o[0] = f0;
          if (col + 1 < n) o[1] = f1;
        }
      } else {
        int* o = static_cast<int*>(out) + idx;
        if (pair) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          o[0] = v0;
          if (col + 1 < n) o[1] = v1;
        }
      }
    }
  }
}

template <int BN>
cudaError_t launch(const int8_t* a, const int8_t* b, void* out,
                   const float* inv_scale, int m, int n, int k,
                   cudaStream_t stream) {
  const int panel = min(kPanel, (k + kBK - 1) / kBK * kBK);
  const int smem = BN * (panel + kPad) + kStagesAB * kBM * kAS;
  const dim3 grid((m + kBM - 1) / kBM, (n + BN - 1) / BN);
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int vec_a = aligned && k % 16 == 0;
  const int vec_b = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  auto kern = aligned && k < kBK ? int8_gemm_kernel<BN, true>
                                 : int8_gemm_kernel<BN, false>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(a, b, out, inv_scale, m, n, k, vec_a,
                                         vec_b);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// X^T.g form: C[M,N] += A[K,M]^T @ B[K,N] over rows [z*chunk, (z+1)*chunk)
// ---------------------------------------------------------------------------

// rows [k0, k0 + kBK) x columns [c0, c0 + W) of a row-major [*, ld] int8
// matrix into dst ([kBK][tn_stride<W>]); rows >= kend and columns >= ld
// zero.  mode 2 (ld <= W, c0 == 0, src 16-byte aligned): the whole rows
// are one 16-byte aligned range (k0 % 16 == 0), copied as it lies (row
// stride ld, zero past kend; what lies past ld in a row belongs to the
// next and meets only output rows past ld, which are dropped).
template <int W>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const int8_t* __restrict__ src,
                                           int ld, int c0, int k0, int kend,
                                           int mode, int tid) {
  constexpr int S = tn_stride<W>();
  if (mode == 2) {
    const int valid = (min(kend, k0 + kBK) - k0) * ld;
    const int8_t* base = src + static_cast<int64_t>(k0) * ld;
    for (int i = tid; i < (kBK * ld + 15) / 16; i += kThreads) {
      const int left = valid - 16 * i;
      cp_async16(dst + 16 * i, left > 0 ? base + 16 * i : src,
                 left > 0 ? min(16, left) : 0);
    }
  } else if (mode == 1) {  // ld % 16 == 0, src 16-byte aligned: chunks
    for (int i = tid; i < kBK * (W / 16); i += kThreads) {
      const int r = i / (W / 16), c = i % (W / 16);
      const int row = k0 + r, col = c0 + 16 * c;
      const bool ok = row < kend && col < ld;
      cp_async16(dst + r * S + 16 * c,
                 ok ? src + static_cast<int64_t>(row) * ld + col : src,
                 ok ? 16 : 0);
    }
  } else {  // rows of any length and alignment, a word at a time, all
            // of a thread's loads issued before its stores
    static_assert(kBK * (W / 4) % kThreads == 0, "whole passes");
    constexpr int kN = kBK * (W / 4) / kThreads;
    uint32_t w[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = tid + j * kThreads, r = i / (W / 4), q = i % (W / 4);
      w[j] = k0 + r < kend ? load_word(src, k0 + r, ld, c0 + 4 * q) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = tid + j * kThreads, r = i / (W / 4), q = i % (W / 4);
      *reinterpret_cast<uint32_t*>(dst + r * S + 4 * q) = w[j];
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
int8_gemm_tn_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    unsigned long long* __restrict__ out, int m, int n, int k,
                    int chunk, int mode_a, int mode_b) {
  constexpr int BM = kBM;  // one m16 tile a warp
  constexpr int AS = tn_stride<BM>();
  constexpr int BS = tn_stride<BN>();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* as = smem;                         // [kStages][kBK][AS]
  unsigned char* bs = smem + kStages * kBK * AS;    // [kStages][kBK][BS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(k, kbeg + chunk);
  const int nk = (kend - kbeg + kBK - 1) / kBK;

  auto load = [&](int stage, int k0) {
    stage_rows<BM>(as + stage * kBK * AS, a, m, m0, k0, kend, mode_a, tid);
    stage_rows<BN>(bs + stage * kBK * BS, b, n, n0, k0, kend, mode_b, tid);
  };
  // the staged row strides (a flat copy keeps the matrix's own)
  const int sa = mode_a == 2 ? m : AS;
  const int sb = mode_b == 2 ? n : BS;

  int acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, kbeg + s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pf = kt + kStages - 1;
    if (pf < nk) load(pf % kStages, kbeg + pf * kBK);
    cp_async_commit();

    const unsigned char* at = as + (kt % kStages) * kBK * AS;
    const unsigned char* bt = bs + (kt % kStages) * kBK * BS;
    const int nsub = min(kBK / 32, (kend - kbeg - kt * kBK + 31) / 32);
    const int mr = warp * 16;
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      if (s >= nsub) break;
      // K rows 32s .. 32s + 31 of the staged tiles
      const unsigned char* ak = at + 32 * s * sa;
      const unsigned char* bk = bt + 32 * s * sb;
      Frag16 bf[BN / 16];
#pragma unroll
      for (int q = 0; q < BN / 16; ++q)
        bf[q] = mode_b == 2 ? frag16_bytes(bk, sb, 16 * q, g, t)
                            : frag16_ldsm(bk, sb, 16 * q, lane);
      if (m0 + mr < m) {
        const Frag16 af = mode_a == 2 ? frag16_bytes(ak, sa, mr, g, t)
                                      : frag16_ldsm(ak, sa, mr, lane);
#pragma unroll
        for (int q = 0; q < BN / 16; ++q) {
          mma_s8(acc[2 * q], af.even[0], af.odd[0], af.even[1], af.odd[1],
                 bf[q].even[0], bf[q].even[1]);
          mma_s8(acc[2 * q + 1], af.even[0], af.odd[0], af.even[1],
                 af.odd[1], bf[q].odd[0], bf[q].odd[1]);
        }
      }
    }
  }

  // The block's int32 partials go through shared memory (the stage
  // buffers, drained) so that each warp's atomics cover consecutive
  // addresses of the output: a row-major [BM, BN] tile of int32.
  // acc[j][e] is mma row g + 8 (e / 2), column 2t + e % 2 of n8 tile j.
  cp_async_wait<0>();
  __syncthreads();
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(warp * 16 + 2 * g + e / 2) * BN + 16 * (j / 2) + 4 * t +
           2 * (e % 2) + j % 2] = acc[j][e];
  __syncthreads();
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int row = m0 + i / BN, col = n0 + i % BN;
    if (row >= m || col >= n || tile[i] == 0) continue;
    atomicAdd(out + static_cast<int64_t>(row) * n + col,
              static_cast<unsigned long long>(
                  static_cast<long long>(tile[i])));
  }
}

constexpr int kMaxChunk = 1 << 16;  // rows per block: exact in int32
constexpr int kTargetBlocks = 2 * 132;  // two blocks for each of 132 SMs
constexpr int kChunk = 768;             // X^T.g: at most this many rows a
                                        // block where K allows more blocks

template <int BN>
cudaError_t launch_tn(const int8_t* a, const int8_t* b,
                      unsigned long long* out, int m, int n, int k,
                      cudaStream_t stream) {
  constexpr int BM = kBM;
  const int smem = kStages * kBK * (tn_stride<BM>() + tn_stride<BN>());
  cudaError_t err = allow_smem(int8_gemm_tn_kernel<BN>, smem);
  if (err != cudaSuccess) return err;
  const int mt = (m + BM - 1) / BM;
  const int nt = (n + BN - 1) / BN;
  // K splits for ~2 blocks per SM, more where a chunk would pass kChunk
  // rows; whole stages
  int splits = max((kTargetBlocks + mt * nt - 1) / (mt * nt),
                   (k + kChunk - 1) / kChunk);
  int chunk = (k + splits - 1) / splits;
  chunk = ((chunk + kBK - 1) / kBK) * kBK;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  splits = (k + chunk - 1) / chunk;
  // how each operand is staged: 1 = 16-byte chunks, 2 = whole rows as
  // one range, 0 = word loads at any alignment
  auto mode = [](const int8_t* p, int ld, int w) {
    const bool aligned = reinterpret_cast<uintptr_t>(p) % 16 == 0;
    return aligned && ld % 16 == 0 ? 1 : (aligned && ld <= w ? 2 : 0);
  };
  const dim3 grid(mt, nt, splits);
  int8_gemm_tn_kernel<BN><<<grid, kThreads, smem, stream>>>(
      a, b, out, m, n, k, chunk, mode(a, m, BM), mode(b, n, BN));
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
  // the N tile: the layer's width, narrowed until the grid fills the card
  const int64_t mt = (static_cast<int64_t>(m) + kBM - 1) / kBM;
  int bn = n <= 16 ? 16 : (n <= 32 ? 32 : 64);
  while (bn > 16 && mt * ((n + bn - 1) / bn) < kTargetBlocks) bn /= 2;
  cudaError_t err;
  if (bn == 16) {
    err = launch<16>(a8, b8, out, s, m, n, k, st);
  } else if (bn == 32) {
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
