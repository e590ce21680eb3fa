// K1: DFXP quantize to integer codes, one launch a call.
//
// Replaces quantize_pallas (lbt_tpu/ops/pallas/quant_kernels.py, body
// _quant_kernel / _quantize_block / _uniform01).  From a contiguous f32
// tensor x (flat index i) and the site's exponent exp (one int32 on the
// device) it computes
//   mult    = 2^(bits-1-exp)                           (written out)
//   codes_i = rint(clip(x_i*mult, -L, L-1))            deterministic
//           | floor(clip(x_i*mult + u_i, -L, L-1))     stochastic
//   minmax  = [min_i x_i*mult, max_i x_i*mult]         on request
// with L = 2^(bits-1), codes int8 (bits <= 8), int16 (<= 16) or int32.
// The noise u_i is one of lbt_tpu's four streams, drawn at the counter
// c_i = i + offset (or (i + offset) % inner for a draw shared along axis
// 0, inner = prod(shape[1:]); offset places the tensor's rows in a larger
// batch's draw, 0 unless a rank evaluates a slice of rows; with a column
// window, i first becomes r * n_global + col0 + j for element (r, j) of x
// read as rows of cols, its place in the whole tensor of which x is the
// columns col0.. of a tensor-parallel rank): its counter hash (lowbias32,
// or one multiply-xorshift round for hash1) of c_i ^ seed, the top 24 bits times 2^-24; or
// jax.random.uniform's threefry (mode 3: Threefry-2x32 of the counter
// (0, c_i) under the site key (seed, k1), the two words xored, 23 bits of
// mantissa); or jax.random.uniform under an unsafe_rbg key (mode 4: word
// c_i % 4 of block c_i / 4 of XLA's Philox4x32-10 stream of the key
// (seed, k1, k2, k3), 23 bits of mantissa; dfxp.cuh).  Mode 4 replaces
// the TPU kernel's hardware draw (pltpu.prng_seed / prng_random_bits,
// quant_kernels.py:32-37) with the stream lbt_tpu draws under the same
// noise_impl off the TPU.  All in 32-bit integer lanes, so the codes
// equal lbt_tpu's quantize_int with backend='xla_hash' / 'xla_hash1' /
// 'xla' (and ops/kernels/quant.py's plain version) bit for bit.
//
// The multiplier: the TPU kernel built it outside (an in-kernel exp2 is a
// VPU polynomial there).  Here it is an integer shift into the exponent
// field, exact: 2^e = bits ((clamp(e, -126, 127) + 127) << 23), inf past
// 2^127, as ops/kernels/quant.py:multiplier builds it.  Every block forms it
// in registers from the exponent; block 0 stores it.  No host sync, no
// extra launch, none of the small torch ops a site used to build it with.
//
// What bounds it on an H100: bytes under the hashes and Philox, integer
// issue under threefry.  4 B in and 1-4 B out an element for a few f32
// and ~10 integer operations: a stage-1 activation of ResNet-20 at batch 128
// (2,097,152 elements, int16 codes) moves 12.6 MB, 3.8 us at 3.35 TB/s
// (ops/kernels/work.py).  Threefry adds at least 69 integer instructions
// an element: at the SMs' issue rate (4 warp instructions an SM a clock)
// that is more than the bytes' time, so mode 3 is bound by operations.
// Philox makes four words from one block of 40 integer instructions:
// where a thread's float4 is one block (no window, no shared draw, an
// offset that is a multiple of 4: every call of the training step), a
// block serves its four elements, 10 instructions an element plus the
// float's 1; the rest draws a block an element.  11 instructions take
// a fifth of the time of an element's 5-6 bytes at the issue rate, so
// mode 4 is bound by bytes, as the hashes are.
// Each mode, and each with its draw shared along axis 0 (a modulo an
// element) or a column window (a division an element), is a template
// instance of its own, so modes 0-2 unshared and unwindowed compile as
// they did before threefry.
// The design:
//   * 256 threads a block, each with two float4 loads in flight before
//     any arithmetic (32 registers, so 8 blocks fit an SM and its warps
//     hide the hash's integer work under each other's loads),
//     neighbouring threads on neighbouring 16-byte chunks, streamed
//     (evict-first: x is read once, the codes stay in L2 for their
//     consumer); codes stored as char4 / short4 / int4;
//   * a grid-stride loop over at most max_blocks blocks (the wrapper
//     passes 4 an SM): at most two passes for every tensor of the path;
//   * the exponent is read after the element loads are issued, so its
//     latency hides under theirs; block 0 stores the multiplier last;
//   * no conversion instructions (16 a clock an SM, against 128 for f32
//     adds): codes of up to 16 bits are rounded by adding 1.5 * 2^23 in
//     round-to-nearest-even (rint) or round-down (floor) mode, and the
//     noise's 24 bits become a float through the mantissa of 1.0;
//   * a tensor whose data does not start 16-byte aligned (a view such as
//     t[1:]) takes a scalar loop over the same flat index: no path tensor
//     does;
//   * min/max in the same launch: each thread's pair, then warp shuffles,
//     then the block through shared memory.  A one-block call writes it.
//     Otherwise, between the block's last arithmetic and its code stores,
//     one thread folds the block's pair into two order-preserving integer
//     keys in the per-stream scratch (atomic max, no return) and draws a
//     ticket there with one release-acquire atomic, so the release waits
//     on no code store and the round trip overlaps them.  The thread that
//     draws the last ticket reads the two keys, writes [min, max] and puts
//     keys and counter back to 0 for the next call on that stream: no
//     block-wide step after the ticket.  (Measured slower on the H100
//     and not kept: each block's pair stored and the last block reducing
//     them; a __threadfence, which is fence.sc, before a plain atomicAdd,
//     after the code stores; four float4 loads a thread.)
//   * no fast math (build.py's NVCC_FLAGS have none): flush-to-zero would
//     zero subnormal inputs that a multiplier of up to 2^127 lifts into
//     range.  Products and sums are __fmul_rn / __fadd_rn, never one FMA,
//     so x*mult + u rounds twice as the plain version does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lbt_tpu_torch/ops/kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "dfxp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;  // float4 loads a thread keeps in flight
// the per-stream scratch: two keys, the ticket a cache line further
constexpr int kScratchWords = 64;
// 1.5 * 2^23: for |v| < 2^22, v + kMagic rounds v to an integer in the
// low mantissa bits, in the addition's rounding mode
constexpr float kMagic = 12582912.0f;

struct Args {
  const float* x;
  void* codes;
  const int* exp;
  float* mult;
  float* minmax;        // [2], or null without statistics
  unsigned int* keys;   // [~key(min), key(max)] of a multi-block call
  unsigned int* ticket;
  unsigned long long n;
  // the hashes' seed in k0, or the key's words (threefry: k0, k1)
  RbgKey key;
  unsigned int inner;  // the counter is i % inner in a SHARED instance
  unsigned int offset;  // added to i before that
  // the column window (a WINDOW instance): i becomes i + (i / cols) * gap
  // + col0 first, gap = n_global - cols
  unsigned int cols, gap, col0;
  int bits;
  int vec;       // x 16-byte and codes 4-code aligned
  int quad;      // mode 4 and a float4's four counters one Philox block
  float lo, hi;  // -L and L-1, as the plain version's f32 clamp bounds
};

template <typename T>
struct Vec4;
template <>
struct Vec4<int8_t> { using type = char4; };
template <>
struct Vec4<int16_t> { using type = short4; };
template <>
struct Vec4<int32_t> { using type = int4; };

// the exponent, loaded where it is written in the source: after the
// element loads it follows, so they are in flight while it arrives (a
// plain load would be hoisted out of the loop and stall them)
__device__ __forceinline__ int load_exp(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// 2^(bits-1-exp) from the IEEE-754 bits; the subtraction wraps as the
// plain version's int32 arithmetic does
__device__ __forceinline__ float mult_of(int exp, int bits) {
  const int e = static_cast<int>(static_cast<unsigned int>(bits - 1) -
                                 static_cast<unsigned int>(exp));
  return e > 127 ? __uint_as_float(0x7F800000u)
                 : __int_as_float((max(e, -126) + 127) << 23);
}

// the stochastic code of scaled + u
template <typename T>
__device__ __forceinline__ T floor_code(float scaled, float u,
                                        const Args& p) {
  const float v = fminf(fmaxf(__fadd_rn(scaled, u), p.lo), p.hi);
  if (sizeof(T) == 4) return static_cast<T>(__float2int_rd(v));
  return static_cast<T>(__float_as_int(__fadd_rd(v, kMagic)) -
                        __float_as_int(kMagic));
}

// MODE 0: round half to even; 1: floor(+hash); 2: floor(+hash1);
// 3: floor(+threefry); 4: floor(+Philox); SHARED: the noise at i % inner;
// WINDOW: at the element's index in the whole tensor of a column slice.
// Codes of at most 16 bits (|v| <= 2^15) round by the magic-number
// addition in round-to-nearest or round-down mode, on the FP32 pipe;
// int32 codes through the conversion unit.
template <typename T, int MODE, bool SHARED, bool WINDOW>
__device__ __forceinline__ T code_of(float scaled, unsigned int idx,
                                     const Args& p) {
  if (MODE == 0) {
    const float v = fminf(fmaxf(scaled, p.lo), p.hi);
    if (sizeof(T) == 4) return static_cast<T>(__float2int_rn(v));
    return static_cast<T>(__float_as_int(__fadd_rn(v, kMagic)) -
                          __float_as_int(kMagic));
  }
  const float u = noise_uniform(
      MODE,
      noise_index<SHARED, WINDOW>(idx, p.inner, p.offset, p.cols, p.gap,
                                  p.col0),
      p.key);
  return floor_code<T>(scaled, u, p);
}

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, o));
  }
}

// min / max over the block; thread 0 holds the result.  Callers separate
// two calls by a __syncthreads (the shared pairs are reused).
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_minmax(lo, hi);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kWarps ? s_lo[lane] : __uint_as_float(0x7F800000u);
    hi = lane < kWarps ? s_hi[lane] : __uint_as_float(0xFF800000u);
    warp_minmax(lo, hi);
  }
}

// The block's [min, max]: written out by a one-block grid; else folded
// into the keys (0 is below every key), and a ticket drawn with a
// release-acquire atomic, so the keys hold the block's pair before the
// count rises.  Returns the ticket in thread 0.
__device__ __forceinline__ unsigned int draw_ticket(float lo, float hi,
                                                    const Args& p) {
  block_minmax(lo, hi);
  unsigned int t = 0;
  if (threadIdx.x == 0) {
    if (gridDim.x == 1) {
      p.minmax[0] = lo;
      p.minmax[1] = hi;
    } else {
      asm volatile("red.relaxed.gpu.global.max.u32 [%0], %1;" ::"l"(p.keys),
                   "r"(~ordered_key(lo))
                   : "memory");
      asm volatile("red.relaxed.gpu.global.max.u32 [%0], %1;" ::"l"(
                       p.keys + 1),
                   "r"(ordered_key(hi))
                   : "memory");
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                   : "=r"(t)
                   : "l"(p.ticket)
                   : "memory");
    }
  }
  return t;
}

// The thread that drew the last ticket (its acquire saw every block's
// keys) decodes [min, max] and resets keys and counter for the next call
// on this stream.
__device__ __forceinline__ void finish_minmax(unsigned int ticket,
                                              const Args& p) {
  if (gridDim.x == 1 || threadIdx.x != 0 || ticket != gridDim.x - 1) return;
  unsigned int klo, khi;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(klo)
               : "l"(p.keys)
               : "memory");
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(khi)
               : "l"(p.keys + 1)
               : "memory");
  p.minmax[0] = key_float(~klo);
  p.minmax[1] = key_float(khi);
  p.keys[0] = 0u;
  p.keys[1] = 0u;
  *p.ticket = 0u;
}

template <typename T, int MODE, bool SHARED, bool WINDOW, bool STATS>
__global__ void __launch_bounds__(kThreads) k1_quantize_kernel(Args p) {
  float lo = __uint_as_float(0x7F800000u);  // +inf
  float hi = __uint_as_float(0xFF800000u);  // -inf
  T* __restrict__ out = static_cast<T*>(p.codes);
  const float* __restrict__ x = p.x;
  // n < 2^32, so float4 indices and the stride fit in 32 bits
  const unsigned int nvec = p.vec ? static_cast<unsigned int>(p.n / 4) : 0u;

  // scalar elements: the last n % 4, or all of a misaligned tensor
  for (unsigned long long i = 4ull * nvec +
                              static_cast<unsigned long long>(blockIdx.x) *
                                  kThreads +
                              threadIdx.x;
       i < p.n; i += static_cast<unsigned long long>(gridDim.x) * kThreads) {
    const float xi = x[i];
    const float s = __fmul_rn(xi, mult_of(load_exp(p.exp), p.bits));
    if (STATS) {
      lo = fminf(lo, s);
      hi = fmaxf(hi, s);
    }
    out[i] = code_of<T, MODE, SHARED, WINDOW>(
        s, static_cast<unsigned int>(i), p);
  }

  // the vector loop; the block's last pass draws the min/max ticket
  // between its arithmetic and its stores
  using V = typename Vec4<T>::type;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  V* __restrict__ o4 = reinterpret_cast<V*>(out);
  const unsigned int stride = gridDim.x * kThreads * kUnroll;
  unsigned int ticket = 0;
  bool drawn = false;  // uniform over the block
  for (unsigned int base = blockIdx.x * kThreads * kUnroll; base < nvec;
       base += stride) {
    const unsigned int b = base + threadIdx.x;
    float4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      v[j] = b + j * kThreads < nvec ? __ldcs(x4 + b + j * kThreads)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    const float mult = mult_of(load_exp(p.exp), p.bits);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      v[j].x = __fmul_rn(v[j].x, mult);
      v[j].y = __fmul_rn(v[j].y, mult);
      v[j].z = __fmul_rn(v[j].z, mult);
      v[j].w = __fmul_rn(v[j].w, mult);
      if (STATS && b + j * kThreads < nvec) {
        lo = fminf(lo, fminf(fminf(v[j].x, v[j].y), fminf(v[j].z, v[j].w)));
        hi = fmaxf(hi, fmaxf(fmaxf(v[j].x, v[j].y), fmaxf(v[j].z, v[j].w)));
      }
    }
    if (STATS && base + stride >= nvec) {
      ticket = draw_ticket(lo, hi, p);
      drawn = true;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const unsigned int k = b + j * kThreads;
      if (k >= nvec) break;
      V c;
      if (MODE == 4 && !SHARED && !WINDOW && p.quad) {
        // counters 4k + offset .. + 3: block k + offset / 4, one for four
        const uint4 r = rbg_block(p.key, k + (p.offset >> 2));
        c.x = floor_code<T>(v[j].x, bits_uniform(r.x), p);
        c.y = floor_code<T>(v[j].y, bits_uniform(r.y), p);
        c.z = floor_code<T>(v[j].z, bits_uniform(r.z), p);
        c.w = floor_code<T>(v[j].w, bits_uniform(r.w), p);
      } else {
        c.x = code_of<T, MODE, SHARED, WINDOW>(v[j].x, 4 * k, p);
        c.y = code_of<T, MODE, SHARED, WINDOW>(v[j].y, 4 * k + 1, p);
        c.z = code_of<T, MODE, SHARED, WINDOW>(v[j].z, 4 * k + 2, p);
        c.w = code_of<T, MODE, SHARED, WINDOW>(v[j].w, 4 * k + 3, p);
      }
      o4[k] = c;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *p.mult = mult_of(load_exp(p.exp), p.bits);
  if (STATS) {
    if (!drawn) ticket = draw_ticket(lo, hi, p);  // no vector pass here
    finish_minmax(ticket, p);
  }
}

template <typename T, int MODE, bool SHARED, bool WINDOW>
cudaError_t launch_mode(const Args& a, bool stats, int grid,
                        cudaStream_t stream) {
  if (stats)
    k1_quantize_kernel<T, MODE, SHARED, WINDOW, true>
        <<<grid, kThreads, 0, stream>>>(a);
  else
    k1_quantize_kernel<T, MODE, SHARED, WINDOW, false>
        <<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int MODE, bool WINDOW>
cudaError_t launch_shared(const Args& a, bool stats, int grid,
                          cudaStream_t stream) {
  return a.inner
             ? launch_mode<T, MODE, true, WINDOW>(a, stats, grid, stream)
             : launch_mode<T, MODE, false, WINDOW>(a, stats, grid, stream);
}

template <typename T, int MODE>
cudaError_t launch_noise(const Args& a, bool window, bool stats, int grid,
                         cudaStream_t stream) {
  return window ? launch_shared<T, MODE, true>(a, stats, grid, stream)
                : launch_shared<T, MODE, false>(a, stats, grid, stream);
}

template <typename T>
cudaError_t launch(const Args& a, int mode, bool window, bool stats,
                   int grid, cudaStream_t stream) {
  if (mode == 1) return launch_noise<T, 1>(a, window, stats, grid, stream);
  if (mode == 2) return launch_noise<T, 2>(a, window, stats, grid, stream);
  if (mode == 3) return launch_noise<T, 3>(a, window, stats, grid, stream);
  if (mode == 4) return launch_noise<T, 4>(a, window, stats, grid, stream);
  return launch_mode<T, 0, false, false>(a, stats, grid, stream);
}

}  // namespace

// C interface for ctypes.  x: n contiguous f32; codes: n codes of
// code_bytes (1 for bits <= 8, 2 for <= 16, else 4) out; exp: one int32 on
// the device; mult: one f32 out; minmax: f32 [2] out, or null for no
// statistics; scratch (with minmax): kScratchWords uint32, zero before
// the first call (each call leaves it so): the two keys, and the ticket
// counter a cache line further; mode 0 rounds half to even, 1 and 2
// stochastically with the hash and hash1 noise of seed, 3 with the
// threefry uniforms of the key (seed, k1), 4 with the Philox uniforms of
// the unsafe_rbg key (seed, k1, k2, k3); the noise of element i is drawn
// at the counter i + offset, or (i + offset) % inner when inner > 0
// (offset + n <= 2^32); n_global > 0 places x, read as rows of cols
// elements, at columns col0.. of rows n_global wide: i is first r *
// n_global + col0 + j for element (r, j), as the whole tensor's draw
// (n_global = 0: no window; the last counter must stay below 2^32).  One
// launch of at most max_blocks blocks on stream; returns
// cudaGetLastError() after it.
extern "C" int lbt_quantize(const void* x, void* codes, int code_bytes,
                            unsigned long long n, const void* exp,
                            void* mult, void* minmax, void* scratch,
                            int max_blocks, int bits, unsigned int seed,
                            unsigned int k1, unsigned int k2,
                            unsigned int k3, unsigned int inner,
                            unsigned int offset, unsigned int cols,
                            unsigned int n_global, unsigned int col0,
                            int mode, void* stream) {
  const int want_bytes = bits <= 8 ? 1 : (bits <= 16 ? 2 : 4);
  const bool window = n_global != 0 && mode != 0;
  // one past the last counter: n + offset, or with the window that of the
  // last row's last column, (rows - 1) * n_global + col0 + cols + offset
  const unsigned long long end =
      !window || n == 0 || cols == 0
          ? n + offset
          : (n / cols - 1) * static_cast<unsigned long long>(n_global) +
                col0 + cols + offset;
  if (bits < 1 || bits > 31 || code_bytes != want_bytes || mode < 0 ||
      mode > 4 || max_blocks < 1 || n >= (1ull << 32) ||
      end > (1ull << 32) ||
      (window && (cols == 0 || n % cols != 0 ||
                  static_cast<unsigned long long>(col0) + cols >
                      n_global)) ||
      (minmax != nullptr && (scratch == nullptr || n == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.codes = codes;
  a.exp = static_cast<const int*>(exp);
  a.mult = static_cast<float*>(mult);
  a.minmax = static_cast<float*>(minmax);
  a.keys = static_cast<unsigned int*>(scratch);
  a.ticket = a.keys == nullptr ? nullptr : a.keys + kScratchWords / 2;
  a.n = n;
  a.key = RbgKey{seed, k1, k2, k3};
  a.inner = inner;
  a.offset = offset;
  a.cols = window ? cols : 1u;
  a.gap = window ? n_global - cols : 0u;
  a.col0 = window ? col0 : 0u;
  a.bits = bits;
  a.vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(codes) % (4 * code_bytes) == 0;
  a.quad = mode == 4 && !window && inner == 0 && offset % 4 == 0;
  const double limit = static_cast<double>(1ull << (bits - 1));
  a.lo = static_cast<float>(-limit);
  a.hi = static_cast<float>(limit - 1.0);
  // a block's pass covers kThreads * kUnroll float4s (vector; block 0
  // also takes the last n % 4 elements) or kThreads * kUnroll elements
  // (scalar); at least one block, for mult
  const unsigned long long per = static_cast<unsigned long long>(kThreads) *
                                 kUnroll;
  const unsigned long long units = a.vec ? n / 4 : n;
  const unsigned long long need = (units + per - 1) / per;
  const int grid = static_cast<int>(
      need < 1 ? 1 : (need > static_cast<unsigned long long>(max_blocks)
                          ? max_blocks
                          : need));
  const bool stats = minmax != nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (code_bytes == 1)
    err = launch<int8_t>(a, mode, window, stats, grid, st);
  else if (code_bytes == 2)
    err = launch<int16_t>(a, mode, window, stats, grid, st);
  else
    err = launch<int32_t>(a, mode, window, stats, grid, st);
  return static_cast<int>(err);
}
