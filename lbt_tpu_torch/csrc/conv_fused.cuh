// Fused int8 conv + DFXP epilogue: the BN-input half of a training forward,
// an implicit GEMM on Hopper's int8 tensor cores.
//
// Replaces conv3x3_fused_int8 (lbt_tpu/ops/pallas/conv_kernels.py,
// _conv3x3_kernel) and conv1x1_fused_int8 (lbt_tpu/ops/pallas/
// conv1x1_kernels.py, _conv1x1_kernel).  From the conv's input codes x
// (int8, or int16 for 9-bit conv activations, NHWC) and weight codes w
// (int8, HWIO) it computes, without writing the f32 conv output:
//   acc     = conv(x, w), exact in int32 (|x*w| <= 2^15, K <= 9*Cin)
//   y       = (float)acc * inv_scale              (inv_scale = 1/(mx*mw))
//           , rounded to bfloat16 (nearest, ties to even) on request: the
//             value a bf16 carrier between the conv and the BN site holds
//   minmax  = [min y, max y]                      (the BN site's controller)
//   q       = floor(clip(y*mult + u, -L, L-1))    (stochastic, u noise)
//           | rint(clip(y*mult, -L, L-1))         (deterministic)
//   moments = [sum q, sum q^2] per output channel, exact in int64
// The noise u is one of lbt_tpu's streams (dfxp.cuh) at the flat NHWC
// output index plus offset (the codes' place in a larger batch's draw;
// modulo inner for a draw shared along axis 0, offset then a multiple of
// inner and so of no effect), the index taken in rows n_global wide with
// this call's Cout at columns col0.. (a tensor-parallel rank's slice of
// the output channels; n_global = Cout and col0 = 0 otherwise): its counter
// hash (lowbias32, or one multiply-xorshift round for hash1) xor the BN
// site's seed, jax.random.uniform's threefry under the site's key, or
// jax.random.uniform under an unsafe_rbg site key: XLA's Philox4x32-10
// stream (dfxp.cuh), which replaces the TPU kernels' hardware draws
// (conv_kernels.py:77,107, conv1x1_kernels.py:57,75).  So the codes equal
// lbt_tpu's quantize_int(conv(x, w), backend='xla_hash' / 'xla_hash1' /
// 'xla') at that site, not a TPU hardware stream.  Threefry adds at least
// 69 integer instructions an output element to the epilogue, Philox 11
// where one block serves four elements; each has kernels of its own (NZ),
// since inlined beside the hash threefry cost the other modes registers
// and spills (#4 and #5 took 6-11% longer at ResNet-50's shapes).  A
// thread holds two adjacent channels of two pixel rows, half of a
// 4-channel Philox block of each row; lanes t and t^1 hold the block's two
// halves.  So the even lane draws row g's block and the odd lane row
// g+8's, and two shuffles swap the halves: one block a lane for four of
// its elements, wherever every pixel's first counter is a multiple of 4
// (the counter's row width, first column and offset are: every call of
// the training step); else a block an element.  The counter is a
// base for each pixel, formed once a pixel (the shared draw's modulo, the
// offset, the column window's row width and first column), plus the
// channel: an addition an element.
//
// Widened past the TPU kernels' asserts (C, K multiples of 128, stride 1)
// to every conv -> BN of ResNet-20 and ResNet-50: Cin = 3..2048, Cout =
// 16..2048 (any Cout, in 64-wide tiles), K up to 4608 (weight panels of
// 1024 K), strides 1 and 2, SAME or explicit padding, any W.  The 1x1
// kernel is the same template with one tap.
//
// What bounds it on an H100: the TPU kernel kept the conv output out of
// HBM; so does this one.  A call reads the input codes once and writes
// int8 codes: a stage-1 call of ResNet-20 at batch 128 moves 6.3 MB (4.2
// MB of int16 codes in, 2.1 MB of codes out) for 0.6 G int8 ops (1.2 G
// through split-9), about 1.9 us of bytes against 0.6 us of tensor-core
// ops at 1,979 TOP/s: bound by bytes (ops/kernels/work.py).  The design:
//   * implicit GEMM: M = B*Ho*Wo output pixels (64 a block, one m16 tile
//     a warp), N = Cout (16, 32 or 64 a block, every n8 tile a warp; the
//     tile narrows until the grid holds two blocks per SM), K = taps x
//     Cin in HWIO order; mma.sync m16n8k32 s8.s8.s32 (IMMA);
//   * staging: each stage of 64 K (32 where K <= 160: the stem, stage 1,
//     the shortcuts, which would otherwise stage up to 37 zero columns a
//     pixel) gathers, per pixel, the taps' Cin-contiguous NHWC rows with
//     16-byte cp.async (3-stage pipeline), zero-filled outside the image
//     and past the last pixel, at any stride and padding.  The pixels'
//     coordinates are decoded once a block, in 32-bit arithmetic.  Inputs
//     whose channel rows are not 16-byte
//     chunks (the stem's Cin = 3) take predicated element loads, all of
//     a thread's issued before it stores them, and the stem's 27 (tap,
//     channel) values fill one zero-padded k32 step;
//   * 9-bit (int16) codes split into int8 planes h = x >> 1 and l = x & 1
//     as fragments are read from shared memory (prmt), and the sum
//     2*(h.w) + l.w runs as three IMMAs into one int32 accumulator:
//     exact, since |acc| <= 576 * 2^15 < 2^31 (gemm.split9's identity);
//   * weights: HWIO is K-major for the GEMM's B once transposed; each
//     block transposes its Cout tile into shared memory once (4x4 byte
//     blocks: four word loads and prmt; panels of at most 1024 K) while
//     its first input stages load;
//   * epilogue on the m16n8 accumulator fragment (rows g and g+8, column
//     pairs 2t, 2t+1), arithmetic unchanged: per-channel int32 sums
//     reduced over the fragment's rows with shuffles, then shared atomics,
//     then int64 atomics; min/max as atomicMax on order-preserving integer
//     keys.  Cross-block results are order-independent.  The last block
//     to finish decodes the keys, so a call is one launch: one thread a
//     block adds the block's keys, fences, and takes a ticket from the
//     counter in the scratch slot; the one that draws the last ticket
//     fences again and decodes.
// What still holds it back: the work of a block is small (64 pixels, a
// few K stages) against its fixed chain of steps (pixel decode, weight
// transposition, pipeline fill, epilogue, reductions, ticket), so the
// kernel runs at a small fraction of its byte bound.  Tried and measured
// slower, so not kept: staging each block's input rows once in shared
// memory (a halo) in place of the taps' L2 re-reads; two accumulators
// (two IMMAs in place of three for split-9), which cost registers; and
// persistent blocks that stream the stages of several tiles through one
// pipeline, whose per-tile epilogue then stalls every warp of the block.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md, chip_smoke.py's
// fused rows): about 0.42 ms of a ResNet-20 training step at batch 128
// for #4 (0.022 for #5) against a 0.022 ms bound (0.00094); 1.57 ms
// before (0.031).
//
// The kernels and their launch live in this header; the entry points of
// each noise kind (NZ) in a source and a library of its own, which the
// build compiles in parallel: conv_fused.cu modes 0-2, conv_fused_
// threefry.cu mode 3, conv_fused_rbg.cu mode 4 (a third of the kernels
// each: one source of them all took 77-87 s to build on the card's
// machine).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lbt_tpu_torch/ops/kernels/build.py), one
//        library a source.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "dfxp.cuh"
#include "int8_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // output pixels per block
constexpr int kStages = 3;
constexpr int kPad = 16;
constexpr int kPanel = 1024;      // K bytes of weights in shared memory

// A stage row stride in bytes for BK (32 or 64) codes a pixel: BK int8
// codes + 16 (12 or 20 words), or BK int16 codes + 32 (24 or 40 words):
// conflict-free 32- and 64-bit fragment loads
template <typename XT, int BK>
__host__ __device__ constexpr int row_bytes() {
  return sizeof(XT) == 1 ? BK + 16 : 2 * BK + 32;
}

struct Args {
  const void* x;
  const int8_t* wt;
  int8_t* codes;
  unsigned long long* moments;  // [2, cout], then the key and ticket slots
  float* minmax;
  const float* inv_scale;
  const float* mult;
  int b, h, w, cin, ho, wo, cout, sh, sw, ph, pw;
  RbgKey key;           // the noise's key words (the hashes' seed in k0)
  unsigned int inner;   // the shared draw's counter modulus
  int mode, round_bf16, vec;     // mode 0 rounds half to even
  int quad;  // mode 4: a lane's block serves four elements (see above)
  float limit;
  unsigned int offset;  // the counter's offset (0 when shared)
  unsigned int ng, col0;  // the counter's row width and first column
};

// the bfloat16 nearest to finite v, ties to even, as a float (inf stays
// inf): PyTorch's float -> bfloat16 conversion
__device__ __forceinline__ float bf16_rn(float v) {
  const unsigned int u = __float_as_uint(v);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// four int16 codes (two words) -> their split-9 planes as int8 words
__device__ __forceinline__ void split9(uint2 v, uint32_t& hi, uint32_t& lo) {
  hi = __byte_perm(v.x >> 1, v.y >> 1, 0x6420);
  lo = __byte_perm(v.x & 0x00010001u, v.y & 0x00010001u, 0x6420);
}

// rows [kq, kq + plen) x columns [n0, n0 + CT) of the [ktot, cout] int8
// weights (HWIO flattened) into dst[CT][stride], transposed: four K bytes
// of one output channel a word; zero past ktot and cout.  With cout % 4 ==
// 0 and w 4-byte aligned, each thread loads a 4x4 block as four words and
// transposes it with prmt.
template <int CT>
__device__ __forceinline__ void stage_w_t(unsigned char* dst, int stride,
                                          const int8_t* __restrict__ w,
                                          int cout, int ktot, int n0, int kq,
                                          int plen, int tid) {
  if (cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0) {
    for (int i = tid; i < (CT / 4) * (plen / 4); i += kThreads) {
      const int c = 4 * (i % (CT / 4)), q = i / (CT / 4);
      const int col = n0 + c, kk = kq + 4 * q;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (col < cout && kk + e < ktot)
                   ? *reinterpret_cast<const uint32_t*>(
                         w + static_cast<int64_t>(kk + e) * cout + col)
                   : 0u;
      const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
      const uint32_t t1 = __byte_perm(v[2], v[3], 0x5140);
      const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362);
      const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
      unsigned char* d = dst + c * stride + 4 * q;
      *reinterpret_cast<uint32_t*>(d) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(d + stride) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(d + 2 * stride) =
          __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(d + 3 * stride) =
          __byte_perm(t2, t3, 0x7632);
    }
  } else {
    for (int i = tid; i < CT * (plen / 4); i += kThreads) {
      const int c = i % CT, q = i / CT;
      const int col = n0 + c, kk = kq + 4 * q;
      uint32_t v = 0;
      if (col < cout) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kk + e < ktot)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(
                     w[static_cast<int64_t>(kk + e) * cout + col]))
                 << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(dst + c * stride + 4 * q) = v;
    }
  }
}

// NZ: the epilogue's noise, 0 the hashes (or none), 1 threefry, 2 Philox
template <int KH, int KW, int CT, int BK, typename XT, int NZ>
__global__ void __launch_bounds__(kThreads) conv_fused_kernel(Args p) {
  constexpr int kE = sizeof(XT);
  constexpr int kRow = row_bytes<XT, BK>();
  constexpr int kCE = 16 / kE;               // codes per 16-byte chunk
  constexpr int kCPP = BK / kCE;            // chunks per pixel per stage
  static_assert(kThreads % kCPP == 0, "a thread keeps one chunk column");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_b[kBM], s_ih[kBM], s_iw[kBM];
  __shared__ int32_t s_sum[CT];
  __shared__ int32_t s_sq[CT];
  __shared__ unsigned int s_key[2];  // [~key(min), key(max)], atomicMax

  const int ktot = KH * KW * p.cin;
  const int panel = min(kPanel, (ktot + BK - 1) / BK * BK);
  const int wstride = panel + kPad;
  unsigned char* ws = smem;                    // [CT][panel + 16], K-major
  unsigned char* as = smem + CT * wstride;     // [kStages][kBM][kRow]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t npix = static_cast<int64_t>(p.b) * p.ho * p.wo;
  const int64_t pix0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * CT;
  const XT* __restrict__ x = static_cast<const XT*>(p.x);
  const float inv = *p.inv_scale;
  const float mult = *p.mult;

  if (tid < CT) { s_sum[tid] = 0; s_sq[tid] = 0; }
  if (tid < 2) s_key[tid] = 0u;

  // each pixel of the block decoded once: batch, top-left input corner
  if (tid < kBM) {
    const int64_t pix = pix0 + tid;
    if (pix < npix) {
      const unsigned int q = static_cast<unsigned int>(pix);
      const unsigned int r = q / static_cast<unsigned int>(p.wo);
      const unsigned int ow = q - r * static_cast<unsigned int>(p.wo);
      const unsigned int bb = r / static_cast<unsigned int>(p.ho);
      s_ih[tid] = static_cast<int>(r - bb * p.ho) * p.sh - p.ph;
      s_iw[tid] = static_cast<int>(ow) * p.sw - p.pw;
      s_b[tid] = static_cast<int>(bb);
    } else {
      s_b[tid] = -1; s_ih[tid] = 0; s_iw[tid] = 0;
    }
  }
  __syncthreads();

  // codes [k0, k0 + BK) of every pixel's K row into stage buffer dst
  auto load_a = [&](unsigned char* dst, int k0) {
    if (p.vec) {  // cin % 16 == 0, x 16-byte aligned: a chunk is one tap's
      const int q = tid % kCPP;
      const int k = k0 + q * kCE;
      const int tap = k / p.cin, c = k - tap * p.cin;
      const int di = tap / KW, dj = tap % KW;
      for (int r = tid / kCPP; r < kBM; r += kThreads / kCPP) {
        const int ih = s_ih[r] + di, iw = s_iw[r] + dj;
        const bool ok = k < ktot && s_b[r] >= 0 && ih >= 0 &&
                        ih < p.h && iw >= 0 && iw < p.w;
        const XT* src =
            ok ? x + ((static_cast<int64_t>(s_b[r]) * p.h + ih) * p.w +
                      iw) * p.cin + c
               : x;
        cp_async16(dst + r * kRow + 16 * q, src, ok ? 16 : 0);
      }
    } else {  // one code at a time: this thread's K column, every pixel,
              // all of its loads issued before its stores
      constexpr int kN = kBM * BK / kThreads;
      const int kk = tid % BK, k = k0 + kk;
      const bool kok = k < ktot;
      const int tap = kok ? k / p.cin : 0, c = k - tap * p.cin;
      const int di = tap / KW, dj = tap % KW;
      XT v[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int r = tid / BK + j * (kThreads / BK);
        const int ih = s_ih[r] + di, iw = s_iw[r] + dj;
        v[j] = (kok && s_b[r] >= 0 && ih >= 0 && ih < p.h && iw >= 0 &&
                iw < p.w)
                   ? x[((static_cast<int64_t>(s_b[r]) * p.h + ih) * p.w +
                        iw) * p.cin + c]
                   : XT(0);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j)
        reinterpret_cast<XT*>(dst + (tid / BK + j * (kThreads / BK)) *
                                        kRow)[kk] = v[j];
    }
  };

  int acc[CT / 8][4];
#pragma unroll
  for (int j = 0; j < CT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int kq = 0; kq < ktot; kq += panel) {
    const int plen = min(panel, (ktot - kq + BK - 1) / BK * BK);
    const int nk = plen / BK;
    __syncthreads();  // the last panel's fragments are read
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_a(as + s * kBM * kRow, kq + s * BK);
      cp_async_commit();
    }
    // the weights' panel, transposed while the first stages are in flight
    stage_w_t<CT>(ws, wstride, p.wt, p.cout, ktot, n0, kq, plen, tid);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int pf = kt + kStages - 1;
      if (pf < nk) load_a(as + (pf % kStages) * kBM * kRow, kq + pf * BK);
      cp_async_commit();

      const unsigned char* at =
          as + (kt % kStages) * kBM * kRow + (warp * 16 + g) * kRow;
      const unsigned char* bt = ws + g * wstride + kt * BK + 4 * t;
      const int nsub = min(BK / 32, (ktot - kq - kt * BK + 31) / 32);
#pragma unroll
      for (int s = 0; s < BK / 32; ++s) {
        if (s >= nsub) break;
        const int ko = 32 * s;
        uint32_t b0[CT / 8], b1[CT / 8];
#pragma unroll
        for (int j = 0; j < CT / 8; ++j) {
          const unsigned char* bp = bt + j * 8 * wstride + ko;
          b0[j] = *reinterpret_cast<const uint32_t*>(bp);
          b1[j] = *reinterpret_cast<const uint32_t*>(bp + 16);
        }
        if (kE == 1) {
          const unsigned char* ap = at + ko + 4 * t;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * kRow);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
          const uint32_t a3 =
              *reinterpret_cast<const uint32_t*>(ap + 8 * kRow + 16);
#pragma unroll
          for (int j = 0; j < CT / 8; ++j)
            mma_s8(acc[j], a0, a1, a2, a3, b0[j], b1[j]);
        } else {
          const unsigned char* ap = at + 2 * (ko + 4 * t);
          uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
          split9(*reinterpret_cast<const uint2*>(ap), h0, l0);
          split9(*reinterpret_cast<const uint2*>(ap + 8 * kRow), h1, l1);
          split9(*reinterpret_cast<const uint2*>(ap + 32), h2, l2);
          split9(*reinterpret_cast<const uint2*>(ap + 8 * kRow + 32), h3, l3);
#pragma unroll
          for (int j = 0; j < CT / 8; ++j) {
            mma_s8(acc[j], h0, h1, h2, h3, b0[j], b1[j]);
            mma_s8(acc[j], h0, h1, h2, h3, b0[j], b1[j]);
            mma_s8(acc[j], l0, l1, l2, l3, b0[j], b1[j]);
          }
        }
      }
    }
  }

  // epilogue: dequant, min/max, quantize to the BN site's codes, moments;
  // this thread holds pixels g and g+8 of its warp's m16 tile, channels
  // 2t and 2t+1 of each n8 tile
  float lo = __uint_as_float(0x7F800000u);  // +inf
  float hi = __uint_as_float(0xFF800000u);  // -inf
  // Philox, one block a lane: the uniforms of (row h, tile j, channel e),
  // drawn by every lane (the shuffles need the whole warp) before the
  // rows past the last pixel drop out
  float ur[2][CT / 8][2];
  if (NZ == 2 && p.quad) {
    const int hm = t & 1;  // the row whose block this lane draws
    const unsigned int pm = static_cast<unsigned int>(
        pix0 + warp * 16 + g + 8 * hm);
    const unsigned int cb =
        (p.inner ? pm % static_cast<unsigned int>(p.ho * p.wo) : pm) * p.ng +
        p.col0 + (p.inner ? 0u : p.offset) + n0 + 4 * (t >> 1);
#pragma unroll
    for (int j = 0; j < CT / 8; ++j) {
      const uint4 r = rbg_block(p.key, (cb + 8 * j) >> 2);
      // the even lane keeps words 0-1 of row g and sends 2-3; the odd
      // lane keeps words 2-3 of row g+8 and sends 0-1
      const unsigned int w0 =
          __shfl_xor_sync(0xFFFFFFFFu, hm ? r.x : r.z, 1);
      const unsigned int w1 =
          __shfl_xor_sync(0xFFFFFFFFu, hm ? r.y : r.w, 1);
      ur[0][j][0] = bits_uniform(hm ? w0 : r.x);
      ur[0][j][1] = bits_uniform(hm ? w1 : r.y);
      ur[1][j][0] = bits_uniform(hm ? r.z : w0);
      ur[1][j][1] = bits_uniform(hm ? r.w : w1);
    }
  }
  int32_t s1[CT / 8][2], s2[CT / 8][2];
#pragma unroll
  for (int j = 0; j < CT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) { s1[j][e] = 0; s2[j][e] = 0; }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t pix = pix0 + warp * 16 + g + 8 * h;
    if (pix >= npix) continue;
    // the noise's counter is cbase + k: pix * ng + col0 + k + offset, or
    // with a draw shared along axis 0 (pix % (ho*wo)) * ng + col0 + k, the
    // index in pix's image (inner = ho*wo*ng; offset 0); ng = cout and
    // col0 = 0 but in a column slice.  The test, the modulo and the
    // multiply-add run once a pixel
    const unsigned int cbase =
        static_cast<unsigned int>(p.inner ? pix % (p.ho * p.wo) : pix) *
            p.ng +
        p.col0 + (p.inner ? 0u : p.offset);
#pragma unroll
    for (int j = 0; j < CT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = n0 + 8 * j + 2 * t + e;
        if (k >= p.cout) continue;
        float y = __fmul_rn(__int2float_rn(acc[j][2 * h + e]), inv);
        if (p.round_bf16) y = bf16_rn(y);
        lo = fminf(lo, y);
        hi = fmaxf(hi, y);
        const float scaled = __fmul_rn(y, mult);
        const int64_t idx = pix * p.cout + k;
        float v;
        if (p.mode) {
          const unsigned int c = cbase + static_cast<unsigned int>(k);
          float u;
          if (NZ == 2)
            u = p.quad ? ur[h][j][e] : rbg_uniform(p.key, c);
          else if (NZ == 1)
            u = threefry_uniform(p.key.k0, p.key.k1, c);
          else
            u = hash_uniform(c, p.key.k0, p.mode == 2);
          v = floorf(fminf(fmaxf(__fadd_rn(scaled, u), -p.limit),
                           p.limit - 1.0f));
        } else {
          v = rintf(fminf(fmaxf(scaled, -p.limit), p.limit - 1.0f));
        }
        const int qi = static_cast<int>(v);
        p.codes[idx] = static_cast<int8_t>(qi);
        s1[j][e] += qi;
        s2[j][e] += qi * qi;
      }
    }
  }
  // sum over the fragment's rows (lanes of equal t), then over warps
#pragma unroll
  for (int j = 0; j < CT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o *= 2) {
        s1[j][e] += __shfl_xor_sync(0xFFFFFFFFu, s1[j][e], o);
        s2[j][e] += __shfl_xor_sync(0xFFFFFFFFu, s2[j][e], o);
      }
      if (g == 0) {
        atomicAdd(&s_sum[8 * j + 2 * t + e], s1[j][e]);
        atomicAdd(&s_sq[8 * j + 2 * t + e], s2[j][e]);
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    lo = fminf(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, o));
  }
  if (lane == 0) {
    atomicMax(&s_key[0], ~ordered_key(lo));
    atomicMax(&s_key[1], ordered_key(hi));
  }
  __syncthreads();
  auto* keys = reinterpret_cast<unsigned int*>(p.moments + 2 * p.cout);
  if (tid < CT && n0 + tid < p.cout) {
    atomicAdd(p.moments + n0 + tid,
              static_cast<unsigned long long>(
                  static_cast<long long>(s_sum[tid])));
    atomicAdd(p.moments + p.cout + n0 + tid,
              static_cast<unsigned long long>(
                  static_cast<long long>(s_sq[tid])));
  }
  if (tid == 0) {
    atomicMax(keys, s_key[0]);
    atomicMax(keys + 1, s_key[1]);
    __threadfence();
    auto* ticket = reinterpret_cast<unsigned int*>(p.moments + 2 * p.cout + 1);
    if (atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1) {
      __threadfence();
      p.minmax[0] = key_float(~atomicOr(keys, 0u));
      p.minmax[1] = key_float(atomicOr(keys + 1, 0u));
    }
  }
}

constexpr int kTargetBlocks = 2 * 132;  // two blocks for each of 132 SMs

template <int KH, int KW, int CT, int BK, typename XT, int NZ>
cudaError_t launch_ct(const Args& a, cudaStream_t stream) {
  const int ktot = KH * KW * a.cin;
  const int panel = min(kPanel, (ktot + BK - 1) / BK * BK);
  const int smem = CT * (panel + kPad) + kStages * kBM * row_bytes<XT, BK>();
  // the kernel's static shared memory: pixel coordinates, channel sums,
  // min/max keys
  constexpr int kStatic = (3 * kBM + 2 * CT + 2) * 4;
  auto kern = conv_fused_kernel<KH, KW, CT, BK, XT, NZ>;
  if (smem + kStatic > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t npix = static_cast<int64_t>(a.b) * a.ho * a.wo;
  const dim3 grid(static_cast<unsigned int>((npix + kBM - 1) / kBM),
                  (a.cout + CT - 1) / CT);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}


template <int KH, int KW, typename XT, int NZ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // the Cout tile: the layer's width, narrowed until the grid fills the card
  const int64_t mt = (static_cast<int64_t>(a.b) * a.ho * a.wo + kBM - 1) / kBM;
  int ct = a.cout <= 16 ? 16 : (a.cout <= 32 ? 32 : 64);
  while (ct > 16 && mt * ((a.cout + ct - 1) / ct) < kTargetBlocks) ct /= 2;
  // 32-deep K stages where K is short (the stem's 27, stage 1's 144, the
  // shortcuts' 16 and 32): less zero padding past K
  if (KH * KW * a.cin <= 160) {
    if (ct == 16) return launch_ct<KH, KW, 16, 32, XT, NZ>(a, stream);
    if (ct == 32) return launch_ct<KH, KW, 32, 32, XT, NZ>(a, stream);
    return launch_ct<KH, KW, 64, 32, XT, NZ>(a, stream);
  }
  if (ct == 16) return launch_ct<KH, KW, 16, 64, XT, NZ>(a, stream);
  if (ct == 32) return launch_ct<KH, KW, 32, 64, XT, NZ>(a, stream);
  return launch_ct<KH, KW, 64, 64, XT, NZ>(a, stream);
}

// The noise kind (NZ) of a mode: 0 the hashes or none, 1 threefry, 2
// Philox
constexpr int noise_kind(int mode) {
  return mode == 4 ? 2 : (mode == 3 ? 1 : 0);
}

// The C entry points' work: checks, Args, then the launch of kind NZ's
// instance, the only kind its library holds (a mode of another kind is
// refused).
template <int KH, int KW, int NZ>
int entry(const void* x, int x_int16, const void* w, void* codes,
          void* moments, void* minmax, const void* inv_scale,
          const void* mult, unsigned int k0, unsigned int k1,
          unsigned int k2, unsigned int k3, unsigned int inner,
          unsigned int offset, unsigned int n_global, unsigned int col0,
          int mode, int round_bf16, int bits_out, const int* dims,
          void* stream) {
  // dims: b, h, w, cin, ho, wo, cout, sh, sw, ph, pw
  Args a;
  a.x = x;
  a.wt = static_cast<const int8_t*>(w);
  a.codes = static_cast<int8_t*>(codes);
  a.moments = static_cast<unsigned long long*>(moments);
  a.minmax = static_cast<float*>(minmax);
  a.inv_scale = static_cast<const float*>(inv_scale);
  a.mult = static_cast<const float*>(mult);
  a.b = dims[0]; a.h = dims[1]; a.w = dims[2]; a.cin = dims[3];
  a.ho = dims[4]; a.wo = dims[5]; a.cout = dims[6];
  a.sh = dims[7]; a.sw = dims[8]; a.ph = dims[9]; a.pw = dims[10];
  a.key = RbgKey{k0, k1, k2, k3};
  a.inner = inner;
  a.offset = offset;
  a.ng = n_global ? n_global : static_cast<unsigned int>(a.cout);
  a.col0 = n_global ? col0 : 0u;
  a.mode = mode;
  a.round_bf16 = round_bf16;
  a.vec = a.cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // every pixel's first counter, pix * ng + col0 + offset (or its image's
  // index * ng + col0 under a shared draw), a multiple of 4
  a.quad = mode == 4 && a.ng % 4 == 0 && a.col0 % 4 == 0 &&
           (inner != 0 || offset % 4 == 0);
  if (a.b < 1 || a.ho < 1 || a.wo < 1 || a.cin < 1 || a.cout < 1 ||
      bits_out < 1 || bits_out > 8 || mode < 0 || mode > 4 ||
      noise_kind(mode) != NZ ||
      static_cast<int64_t>(a.col0) + a.cout > static_cast<int64_t>(a.ng) ||
      (inner != 0 &&
       (offset != 0 || static_cast<int64_t>(inner) !=
                           static_cast<int64_t>(a.ho) * a.wo * a.ng)) ||
      (static_cast<int64_t>(a.b) * a.ho * a.wo - 1) * a.ng + a.col0 +
              a.cout + offset >
          (1ll << 32) ||
      static_cast<int64_t>(a.b) * a.ho * a.wo > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  a.limit = static_cast<float>(1 << (bits_out - 1));
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_int16 ? launch<KH, KW, int16_t, NZ>(a, st)
                                  : launch<KH, KW, int8_t, NZ>(a, st);
  return static_cast<int>(err);
}

}  // namespace
