// Fused int8 conv + DFXP epilogue: the BN-input half of a training forward.
//
// Replaces conv3x3_fused_int8 (lbt_tpu/ops/pallas/conv_kernels.py,
// _conv3x3_kernel) and conv1x1_fused_int8 (lbt_tpu/ops/pallas/
// conv1x1_kernels.py, _conv1x1_kernel).  From the conv's input codes x
// (int8, or int16 for 9-bit conv activations, NHWC) and weight codes w
// (int8, HWIO) it computes, without writing the f32 conv output:
//   acc     = conv(x, w), exact in int32 (|x*w| <= 2^15, K <= 9*Cin)
//   y       = (float)acc * inv_scale              (inv_scale = 1/(mx*mw))
//   minmax  = [min y, max y]                      (the BN site's controller)
//   q       = floor(clip(y*mult + u, -L, L-1))    (stochastic, u = hash)
//           | rint(clip(y*mult, -L, L-1))         (deterministic)
//   moments = [sum q, sum q^2] per output channel, exact in int64
// The noise u is lbt_tpu's counter hash (lowbias32, or one multiply-
// xorshift round for hash1) of the flat NHWC output index xor the BN
// site's seed, so the codes equal lbt_tpu's quantize_int(conv(x, w),
// backend='xla_hash') at that site, not a TPU hardware stream.
//
// Widened past the TPU kernels' asserts (C, K multiples of 128, stride 1)
// to every conv of ResNet-20: Cin = 3..64, Cout = 16..64 (any Cout, in
// 64-wide tiles), strides 1 and 2, SAME or explicit padding, any W.  The
// 1x1 kernel is the same template with one tap: a [B*Ho*Wo, Cin] x
// [Cin, Cout] GEMM whose rows are gathered at the stride.
//
// What bounds it on an H100, and the design: the TPU kernel kept the conv
// output out of HBM; so does this one.  ResNet-20's convs are small
// (16-64 channels), so this first version is a direct convolution on CUDA
// cores: a block owns 128 output pixels x up to 64 output channels; for
// each tap and each stage of 16 input channels it stages the pixels'
// input codes and the tap's weights in shared memory as int32 and runs
// int32 multiply-adds (no split of 9-bit codes needed), 8 pixels x
// Cout/16 channels per thread.  Each thread decodes its pixels once, so
// the tap loop does no integer division.  Cross-block results are
// order-independent: moments are int64 atomics of per-block int32 sums,
// min/max are atomicMax on order-preserving integer keys, decoded by a
// one-thread second kernel.  Tensor cores (mma.sync int8 on split-9
// planes) and implicit-GEMM tiles are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lbt_tpu_torch/ops/kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBP = 128;                   // output pixels per block
constexpr int kCK = 16;                    // input channels per stage
constexpr int kPT = kBP / (kThreads / 16);  // pixels per thread (8)
constexpr int kLD = kBP * kCK / kThreads;  // staged inputs per thread (8)
static_assert(kThreads % kCK == 0, "a thread keeps one channel lane");

struct Args {
  const void* x;
  const int8_t* wt;
  int8_t* codes;
  unsigned long long* moments;  // [2, cout] then two uint32 min/max keys
  const float* inv_scale;
  const float* mult;
  int b, h, w, cin, ho, wo, cout, sh, sw, ph, pw;
  unsigned int seed;
  int stochastic, light;
  float limit;
};

// float -> uint32 whose unsigned order is the float order (no NaN)
__device__ __forceinline__ unsigned int ordered_key(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ float hash_uniform(unsigned int idx,
                                              unsigned int seed, int light) {
  unsigned int h = idx ^ seed;
  if (!light) h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  if (!light) h ^= h >> 16;
  return __uint2float_rn(h >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

template <int KH, int KW, int CT, typename XT>
__global__ void __launch_bounds__(kThreads) conv_fused_kernel(Args p) {
  constexpr int kKJ = CT / 16;  // output channels per thread
  __shared__ int32_t xs[kBP][kCK + 1];
  __shared__ int32_t ws[kCK][CT];
  __shared__ int32_t s_sum[CT];
  __shared__ int32_t s_sq[CT];
  __shared__ unsigned int s_key[2];  // [~key(min), key(max)], atomicMax

  const int tid = threadIdx.x;
  const int pg = tid / 16;  // this thread's pixel group
  const int kg = tid % 16;  // this thread's channel lane
  const int64_t npix = static_cast<int64_t>(p.b) * p.ho * p.wo;
  const int64_t pix0 = static_cast<int64_t>(blockIdx.x) * kBP;
  const int k0 = blockIdx.y * CT;
  const XT* __restrict__ x = static_cast<const XT*>(p.x);

  if (tid < CT) { s_sum[tid] = 0; s_sq[tid] = 0; }
  if (tid < 2) s_key[tid] = 0u;

  // the pixels this thread stages: pl = tid/kCK + t*(kThreads/kCK)
  const int cc = tid % kCK;
  int ld_b[kLD], ld_oh[kLD], ld_ow[kLD];
#pragma unroll
  for (int t = 0; t < kLD; ++t) {
    const int64_t pix = pix0 + tid / kCK + t * (kThreads / kCK);
    if (pix < npix) {
      ld_ow[t] = static_cast<int>(pix % p.wo);
      const int64_t r = pix / p.wo;
      ld_oh[t] = static_cast<int>(r % p.ho);
      ld_b[t] = static_cast<int>(r / p.ho);
    } else {
      ld_b[t] = -1; ld_oh[t] = 0; ld_ow[t] = 0;
    }
  }

  int32_t acc[kPT][kKJ];
#pragma unroll
  for (int r = 0; r < kPT; ++r)
#pragma unroll
    for (int q = 0; q < kKJ; ++q) acc[r][q] = 0;

  for (int i = 0; i < KH; ++i) {
    for (int j = 0; j < KW; ++j) {
      for (int c0 = 0; c0 < p.cin; c0 += kCK) {
        const int c = c0 + cc;
#pragma unroll
        for (int t = 0; t < kLD; ++t) {
          const int ih = ld_oh[t] * p.sh + i - p.ph;
          const int iw = ld_ow[t] * p.sw + j - p.pw;
          int32_t v = 0;
          if (ld_b[t] >= 0 && c < p.cin && ih >= 0 && ih < p.h && iw >= 0 &&
              iw < p.w)
            v = x[((static_cast<int64_t>(ld_b[t]) * p.h + ih) * p.w + iw) *
                      p.cin + c];
          xs[tid / kCK + t * (kThreads / kCK)][cc] = v;
        }
        for (int e = tid; e < kCK * CT; e += kThreads) {
          const int ci = c0 + e / CT;
          const int k = k0 + e % CT;
          ws[e / CT][e % CT] =
              (ci < p.cin && k < p.cout)
                  ? p.wt[((i * KW + j) * p.cin + ci) * p.cout + k]
                  : 0;
        }
        __syncthreads();
#pragma unroll
        for (int ci = 0; ci < kCK; ++ci) {
          int32_t xv[kPT], wv[kKJ];
#pragma unroll
          for (int r = 0; r < kPT; ++r) xv[r] = xs[pg * kPT + r][ci];
#pragma unroll
          for (int q = 0; q < kKJ; ++q) wv[q] = ws[ci][kg + 16 * q];
#pragma unroll
          for (int r = 0; r < kPT; ++r)
#pragma unroll
            for (int q = 0; q < kKJ; ++q) acc[r][q] += xv[r] * wv[q];
        }
        __syncthreads();
      }
    }
  }

  // epilogue: dequant, min/max, quantize to the BN site's codes, moments
  const float inv = *p.inv_scale;
  const float mult = *p.mult;
  float lo = __uint_as_float(0x7F800000u);  // +inf
  float hi = __uint_as_float(0xFF800000u);  // -inf
  int32_t s1[kKJ], s2[kKJ];
#pragma unroll
  for (int q = 0; q < kKJ; ++q) { s1[q] = 0; s2[q] = 0; }
#pragma unroll
  for (int r = 0; r < kPT; ++r) {
    const int64_t pix = pix0 + pg * kPT + r;
    if (pix >= npix) continue;
#pragma unroll
    for (int q = 0; q < kKJ; ++q) {
      const int k = k0 + kg + 16 * q;
      if (k >= p.cout) continue;
      const float y = __fmul_rn(__int2float_rn(acc[r][q]), inv);
      lo = fminf(lo, y);
      hi = fmaxf(hi, y);
      const float scaled = __fmul_rn(y, mult);
      const int64_t idx = pix * p.cout + k;
      float v;
      if (p.stochastic) {
        const float u = hash_uniform(static_cast<unsigned int>(idx), p.seed,
                                     p.light);
        v = floorf(fminf(fmaxf(__fadd_rn(scaled, u), -p.limit),
                         p.limit - 1.0f));
      } else {
        v = rintf(fminf(fmaxf(scaled, -p.limit), p.limit - 1.0f));
      }
      const int qi = static_cast<int>(v);
      p.codes[idx] = static_cast<int8_t>(qi);
      s1[q] += qi;
      s2[q] += qi * qi;
    }
  }
#pragma unroll
  for (int q = 0; q < kKJ; ++q) {
    atomicAdd(&s_sum[kg + 16 * q], s1[q]);
    atomicAdd(&s_sq[kg + 16 * q], s2[q]);
  }
  atomicMax(&s_key[0], ~ordered_key(lo));
  atomicMax(&s_key[1], ordered_key(hi));
  __syncthreads();
  if (tid < CT && k0 + tid < p.cout) {
    atomicAdd(p.moments + k0 + tid,
              static_cast<unsigned long long>(
                  static_cast<long long>(s_sum[tid])));
    atomicAdd(p.moments + p.cout + k0 + tid,
              static_cast<unsigned long long>(
                  static_cast<long long>(s_sq[tid])));
  }
  if (tid < 2) {
    auto* keys = reinterpret_cast<unsigned int*>(p.moments + 2 * p.cout);
    atomicMax(keys + tid, s_key[tid]);
  }
}

__global__ void minmax_decode_kernel(const unsigned long long* moments,
                                     int cout, float* minmax) {
  const auto* keys = reinterpret_cast<const unsigned int*>(moments + 2 * cout);
  minmax[0] = key_float(~keys[0]);
  minmax[1] = key_float(keys[1]);
}

template <int KH, int KW, typename XT>
cudaError_t launch(const Args& a, float* minmax, cudaStream_t stream) {
  const int64_t npix = static_cast<int64_t>(a.b) * a.ho * a.wo;
  const int ct = a.cout <= 16 ? 16 : (a.cout <= 32 ? 32 : 64);
  const dim3 grid(static_cast<unsigned int>((npix + kBP - 1) / kBP),
                  (a.cout + ct - 1) / ct);
  if (ct == 16) {
    conv_fused_kernel<KH, KW, 16, XT><<<grid, kThreads, 0, stream>>>(a);
  } else if (ct == 32) {
    conv_fused_kernel<KH, KW, 32, XT><<<grid, kThreads, 0, stream>>>(a);
  } else {
    conv_fused_kernel<KH, KW, 64, XT><<<grid, kThreads, 0, stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  minmax_decode_kernel<<<1, 1, 0, stream>>>(a.moments, a.cout, minmax);
  return cudaGetLastError();
}

template <int KH, int KW>
int entry(const void* x, int x_int16, const void* w, void* codes,
          void* moments, void* minmax, const void* inv_scale,
          const void* mult, unsigned int seed, int stochastic, int light,
          int bits_out, const int* dims, void* stream) {
  // dims: b, h, w, cin, ho, wo, cout, sh, sw, ph, pw
  Args a;
  a.x = x;
  a.wt = static_cast<const int8_t*>(w);
  a.codes = static_cast<int8_t*>(codes);
  a.moments = static_cast<unsigned long long*>(moments);
  a.inv_scale = static_cast<const float*>(inv_scale);
  a.mult = static_cast<const float*>(mult);
  a.b = dims[0]; a.h = dims[1]; a.w = dims[2]; a.cin = dims[3];
  a.ho = dims[4]; a.wo = dims[5]; a.cout = dims[6];
  a.sh = dims[7]; a.sw = dims[8]; a.ph = dims[9]; a.pw = dims[10];
  a.seed = seed;
  a.stochastic = stochastic;
  a.light = light;
  if (a.b < 1 || a.ho < 1 || a.wo < 1 || a.cin < 1 || a.cout < 1 ||
      bits_out < 1 || bits_out > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  a.limit = static_cast<float>(1 << (bits_out - 1));
  auto st = static_cast<cudaStream_t>(stream);
  auto* mm = static_cast<float*>(minmax);
  cudaError_t err = x_int16 ? launch<KH, KW, int16_t>(a, mm, st)
                            : launch<KH, KW, int8_t>(a, mm, st);
  return static_cast<int>(err);
}

}  // namespace

// C interface for ctypes.  x: int8 or (x_int16 != 0) int16 NHWC codes;
// w: int8 HWIO codes; codes: int8 [b, ho, wo, cout] out; moments: int64
// [2*cout + 1], zeroed by the caller ([sum q; sum q^2], then scratch for
// the min/max keys); minmax: float [2] out; inv_scale, mult: one float
// each on the device.  Returns cudaGetLastError() after the launches.
extern "C" int lbt_conv3x3_fused(const void* x, int x_int16, const void* w,
                                 void* codes, void* moments, void* minmax,
                                 const void* inv_scale, const void* mult,
                                 unsigned int seed, int stochastic, int light,
                                 int bits_out, const int* dims, void* stream) {
  return entry<3, 3>(x, x_int16, w, codes, moments, minmax, inv_scale, mult,
                     seed, stochastic, light, bits_out, dims, stream);
}

extern "C" int lbt_conv1x1_fused(const void* x, int x_int16, const void* w,
                                 void* codes, void* moments, void* minmax,
                                 const void* inv_scale, const void* mult,
                                 unsigned int seed, int stochastic, int light,
                                 int bits_out, const int* dims, void* stream) {
  return entry<1, 1>(x, x_int16, w, codes, moments, minmax, inv_scale, mult,
                     seed, stochastic, light, bits_out, dims, stream);
}
