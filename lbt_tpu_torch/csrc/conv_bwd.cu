// The int8 conv backward as two implicit GEMMs on Hopper's int8 tensor
// cores: dgrad (the input's gradient) and wgrad (the weight's), each
// gathering its taps in its shared-memory loader.
//
// They replace no Pallas kernel: lbt_tpu's XLA emitted the conv's
// transposes (lbt_tpu/ops/qops.py, _dx_conv_params and the dW conv), and
// the port first ran them as K2 over im2col patches of a zero-dilated,
// padded copy of the cotangent (dx) and of the input codes (dW).  For the
// NHWC cotangent codes g [B,Ho,Wo,Cout], input codes x [B,H,W,Cin] and HWIO
// weight codes W [kh,kw,Cin,Cout] (int8; TF-style pads whose top and left
// are ph, pw) they compute, exactly:
//   dgrad  dx[b,h,w,ci] = sum g[b,(h+ph-i)/sh,(w+pw-j)/sw,co] W[i,j,ci,co]
//          over the taps whose division is exact and in range, int32 sums
//          stored raw or as __int2float_rn(acc) * inv (K2 AB's epilogue);
//   wgrad  dW[(i,j,ci),co] = sum x[b,ho*sh+i-ph,wo*sw+j-pw,ci] g[b,ho,wo,co]
//          over the pixels, into int64 (K2 X^T.g's split-K sums).
//
// What bounds them on an H100: the bytes.  At ResNet-50/224 and batch 256
// the 52 dgrad calls of a training step move 13.4 GB for 1.96 T useful
// int8 ops, the 52 wgrad calls 5.2 GB for 1.96 T (ops/kernels/work.py):
// 4.0 and 1.6 ms of bytes at 3.35 TB/s against 1.0 ms of tensor-core ops
// each at 1,979 TOP/s.  The im2col route wrote 12.3 GB of patches a step
// (7.2 GB for dx, 5.1 GB for dW) and read them again, besides its dilated
// and padded copies, and its dx GEMMs did 3.04 T ops for those 1.96 T: the
// rest multiplied the dilation's zeros at the stride-2 convs.
// So the design moves only the operands:
//   * implicit GEMM, mma.sync m16n8k32 s8.s8.s32 (IMMA), warps of one m16
//     tile each against every n8 tile of the block's N; 16-byte cp.async
//     copies of NHWC rows (Cin and Cout multiples of 16), zero-filled
//     outside the image, past the last pixel and past K (K2's ragged-edge
//     idiom, #4's loader);
//   * dgrad: M = B*H*W dx pixels, N = Cin, K = taps x Cout, blocks of 128
//     pixels (8 warps) and up to 128 channels, narrowed until the grid
//     fills the card.  At stride s the dx pixels split by their row and
//     column modulo s into s^2 classes; within a class the taps are those
//     of one residue and each reads g at a fixed offset from the pixel, so
//     a class is a dense stride-1 problem over its own taps and no zero is
//     multiplied (a class with no tap, as odd rows under a 1x1 stride-2
//     conv, writes zeros).  The classes' pixel tiles share one grid.  The
//     flip is an index: W[i,j,ci,co..co+16) is K-contiguous for the B
//     fragment, so no transposed weight is copied; both operands stream
//     through a 4-stage pipeline;
//   * wgrad: K2 X^T.g's main loop as it stands (ldmatrix .trans and prmt
//     fragments in a fixed K order both operands share, int32 sums over at
//     most 2^16 pixels a block, int64 split-K atomics staged through
//     shared memory, order-independent); only its A loader differs: each
//     thread's 16 columns are one tap's channels, read at the tap-shifted
//     pixel.  Blocks of one pixel chunk's taps run side by side, so the
//     taps' re-reads of x come from L2.  A block takes up to 2048 pixels
//     where K2 takes 768: fewer blocks, fewer int64 atomics.
// 9-bit (int16) input codes take wgrad twice, on their split-9 planes
// (ops/kernels/conv_bwd.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (lbt_tpu_torch/ops/kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

constexpr int kWarps = 4;  // wgrad, K2 X^T.g's block (8 warps took 5% more)
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // rows a block: one m16 tile a warp
constexpr int kWarpsD = 8;  // dgrad: 128 dx pixels a block, against up to
                            // 128 channels (64 x 64 took 52% more: each
                            // block re-reads its weight rows and g rows)
constexpr int kThreadsD = 32 * kWarpsD;
constexpr int kBMD = 16 * kWarpsD;
constexpr int kBK = 64;           // K bytes (dgrad) or pixels (wgrad) a stage
constexpr int kRow = kBK + 16;    // a staged 64-byte row's stride: five
                                  // 16-byte chunks, conflict-free fragments
constexpr int kStagesD = 4;       // cp.async pipeline depth, dgrad
constexpr int kStagesW = 3;       // and wgrad (K2 X^T.g's)
constexpr int kTargetBlocks = 2 * 132;  // two blocks for each of 132 SMs
constexpr int kMaxChunk = 1 << 16;      // wgrad: pixels a block, exact int32
constexpr int kChunk = 2048;  // wgrad: at most this many a block where the
                              // pixels allow more blocks (K2's 768 spent
                              // 10% more at ResNet-50's shapes: more int64
                              // atomics)
constexpr int kMaxClasses = 16;  // dgrad: stride classes a launch

// ---------------------------------------------------------------------------
// dgrad: dx[M = B*H*W, N = Cin] over K = taps x Cout, class by class
// ---------------------------------------------------------------------------

// The dx pixels (b, rh + sh*hc, rw + sw*wc) of one stride class, and its
// taps (i0 + sh*a, j0 + sw*c): tap (a, c) reads g at (hc + dh0 - a,
// wc + dw0 - c).
struct DgradClass {
  int rh, rw, hc, wc;
  int i0, j0, nth, ntw, dh0, dw0;
  int tile0;  // the class's first block in the launch
};

struct DgradArgs {
  const int8_t* g;
  const int8_t* w;
  void* out;
  const float* inv;  // null: int32 sums
  int b, h, w_, cin, ho, wo, cout, kw, sh, sw;
  int nclass;
  DgradClass cls[kMaxClasses];
};

template <int BN>
__global__ void __launch_bounds__(kThreadsD)
conv_dgrad_kernel(const DgradArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_b[kBMD], s_oh[kBMD], s_ow[kBMD];
  __shared__ long long s_out[kBMD];
  unsigned char* as = smem;                           // [kStagesD][kBMD][kRow]
  unsigned char* bs = smem + kStagesD * kBMD * kRow;  // [kStagesD][BN][kRow]

  DgradClass cl = p.cls[0];
#pragma unroll
  for (int c = 1; c < kMaxClasses; ++c)
    if (c < p.nclass && p.cls[c].tile0 <= static_cast<int>(blockIdx.x))
      cl = p.cls[c];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.y * BN;

  // each dx pixel of the block decoded once: its batch, g's row and column
  // at the class's first tap, and its own index in dx
  if (tid < kBMD) {
    const int hw = cl.hc * cl.wc;
    const int q = (static_cast<int>(blockIdx.x) - cl.tile0) * kBMD + tid;
    if (q < p.b * hw) {
      const int bb = q / hw, r = q - bb * hw;
      const int hc = r / cl.wc, wc = r - hc * cl.wc;
      s_b[tid] = bb;
      s_oh[tid] = hc + cl.dh0;
      s_ow[tid] = wc + cl.dw0;
      s_out[tid] = (static_cast<long long>(bb) * p.h + cl.rh + p.sh * hc) *
                       p.w_ + cl.rw + p.sw * wc;
    } else {
      s_b[tid] = -1; s_oh[tid] = 0; s_ow[tid] = 0; s_out[tid] = 0;
    }
  }
  __syncthreads();

  const int ktot = cl.nth * cl.ntw * p.cout;
  const int nk = (ktot + kBK - 1) / kBK;
  const int q16 = tid % (kBK / 16);  // this thread's 16-byte chunk of a row

  // K bytes [k0, k0 + 64) of the block's rows of g (gathered at each tap's
  // offset) and of its Cin rows of W, into stage `stage`.  A chunk lies in
  // one tap: Cout is a multiple of 16.
  auto load = [&](int stage, int k0) {
    const int k = k0 + 16 * q16;
    const bool kok = k < ktot;
    const int tap = kok ? k / p.cout : 0;
    const int co = k - tap * p.cout;
    const int a = tap / cl.ntw, c = tap - a * cl.ntw;
    unsigned char* da = as + stage * kBMD * kRow + 16 * q16;
    for (int r = tid / 4; r < kBMD; r += kThreadsD / 4) {
      const int oh = s_oh[r] - a, ow = s_ow[r] - c;
      const bool ok = kok && s_b[r] >= 0 && oh >= 0 && oh < p.ho && ow >= 0 &&
                      ow < p.wo;
      const int8_t* src =
          ok ? p.g + ((static_cast<int64_t>(s_b[r]) * p.ho + oh) * p.wo +
                      ow) * p.cout + co
             : p.g;
      cp_async16(da + r * kRow, src, ok ? 16 : 0);
    }
    // W[i, j, n0 + n, co .. co + 16): the flipped kernel's B rows as
    // they lie
    const int8_t* wt =
        p.w + static_cast<int64_t>((cl.i0 + p.sh * a) * p.kw + cl.j0 +
                                   p.sw * c) * p.cin * p.cout + co;
    unsigned char* db = bs + stage * BN * kRow + 16 * q16;
    for (int n = tid / 4; n < BN; n += kThreadsD / 4) {
      const bool ok = kok && n0 + n < p.cin;
      cp_async16(db + n * kRow,
                 ok ? wt + static_cast<int64_t>(n0 + n) * p.cout : p.w,
                 ok ? 16 : 0);
    }
  };

  int acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStagesD - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStagesD - 2>();
    __syncthreads();
    const int pf = kt + kStagesD - 1;
    if (pf < nk) load(pf % kStagesD, pf * kBK);
    cp_async_commit();

    const int st = kt % kStagesD;
    const unsigned char* at =
        as + st * kBMD * kRow + (warp * 16 + g) * kRow + 4 * t;
    const unsigned char* bt = bs + st * BN * kRow + g * kRow + 4 * t;
    const int nsub = min(kBK / 32, (ktot - kt * kBK + 31) / 32);
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      if (s >= nsub) break;
      const int ko = 32 * s;
      const uint32_t a0 = ld32(at + ko), a1 = ld32(at + 8 * kRow + ko);
      const uint32_t a2 = ld32(at + ko + 16);
      const uint32_t a3 = ld32(at + 8 * kRow + ko + 16);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const unsigned char* bp = bt + j * 8 * kRow + ko;
        mma_s8(acc[j], a0, a1, a2, a3, ld32(bp), ld32(bp + 16));
      }
    }
  }

  // rows g and g+8 of the warp's m16 tile, columns 2t and 2t+1 of each n8
  // (Cin is even: the pair is whole)
  const float scale = p.inv != nullptr ? *p.inv : 0.0f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      if (s_b[r] < 0 || col >= p.cin) continue;
      const int64_t idx = s_out[r] * p.cin + col;
      const int v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      if (p.inv != nullptr) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) =
            make_float2(__int2float_rn(v0) * scale,
                        __int2float_rn(v1) * scale);
      } else {
        *reinterpret_cast<int2*>(static_cast<int*>(p.out) + idx) =
            make_int2(v0, v1);
      }
    }
  }
}

template <int BN>
cudaError_t launch_dgrad(const DgradArgs& a, int tiles, cudaStream_t stream) {
  const int smem = kStagesD * (kBMD + BN) * kRow;
  cudaError_t err = allow_smem(conv_dgrad_kernel<BN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (a.cin + BN - 1) / BN);
  conv_dgrad_kernel<BN><<<grid, kThreadsD, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_dgrad_classes(const DgradArgs& a, int tiles,
                                 cudaStream_t stream) {
  // the N tile: the layer's width, narrowed until the grid fills the card
  int bn = a.cin <= 16 ? 16 : (a.cin <= 32 ? 32 : (a.cin <= 64 ? 64 : 128));
  while (bn > 16 &&
         static_cast<int64_t>(tiles) * ((a.cin + bn - 1) / bn) <
             kTargetBlocks)
    bn /= 2;
  if (bn == 16) return launch_dgrad<16>(a, tiles, stream);
  if (bn == 32) return launch_dgrad<32>(a, tiles, stream);
  if (bn == 64) return launch_dgrad<64>(a, tiles, stream);
  return launch_dgrad<128>(a, tiles, stream);
}

// ---------------------------------------------------------------------------
// wgrad: dW[M = kh*kw*Cin, N = Cout] += over K = B*Ho*Wo pixels, split-K
// ---------------------------------------------------------------------------

struct WgradArgs {
  const int8_t* x;
  const int8_t* g;
  unsigned long long* out;
  int b, h, w_, cin, ho, wo, cout, kw, sh, sw, ph, pw;
  int m, npix, chunk;
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_wgrad_kernel(const WgradArgs p) {
  constexpr int AS = tn_stride<kBM>();
  constexpr int BS = tn_stride<BN>();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* as = smem;                         // [kStagesW][kBK][AS]
  unsigned char* bs = smem + kStagesW * kBK * AS;   // [kStagesW][kBK][BS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * p.chunk;
  const int kend = min(p.npix, kbeg + p.chunk);
  const int nk = (kend - kbeg + kBK - 1) / kBK;

  // this thread's 16 columns of A, fixed for the block: 16 channels of one
  // tap (Cin is a multiple of 16), read at the tap's offset from each pixel
  const int q16 = tid % (kBM / 16);
  const int mcol = m0 + 16 * q16;
  const bool mok = mcol < p.m;
  const int tap = mok ? mcol / p.cin : 0;
  const int ci = mcol - tap * p.cin;
  const int di = tap / p.kw - p.ph, dj = tap % p.kw - p.pw;
  const int hw = p.ho * p.wo;

  auto load = [&](int stage, int k0) {
    unsigned char* da = as + stage * kBK * AS + 16 * q16;
    for (int r = tid / (kBM / 16); r < kBK; r += kThreads / (kBM / 16)) {
      const int pix = k0 + r;
      bool ok = mok && pix < kend;
      const int8_t* src = p.x;
      if (ok) {
        const int bb = pix / hw, rem = pix - bb * hw;
        const int oh = rem / p.wo, ow = rem - oh * p.wo;
        const int ih = oh * p.sh + di, iw = ow * p.sw + dj;
        ok = ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_;
        if (ok)
          src = p.x + ((static_cast<int64_t>(bb) * p.h + ih) * p.w_ + iw) *
                          p.cin + ci;
      }
      cp_async16(da + r * AS, src, ok ? 16 : 0);
    }
    unsigned char* db = bs + stage * kBK * BS;
    for (int i = tid; i < kBK * (BN / 16); i += kThreads) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      const int pix = k0 + r, col = n0 + 16 * c;
      const bool ok = pix < kend && col < p.cout;
      cp_async16(db + r * BS + 16 * c,
                 ok ? p.g + static_cast<int64_t>(pix) * p.cout + col : p.g,
                 ok ? 16 : 0);
    }
  };

  int acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStagesW - 1; ++s) {
    if (s < nk) load(s, kbeg + s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStagesW - 2>();
    __syncthreads();
    const int pf = kt + kStagesW - 1;
    if (pf < nk) load(pf % kStagesW, kbeg + pf * kBK);
    cp_async_commit();

    const unsigned char* at = as + (kt % kStagesW) * kBK * AS;
    const unsigned char* bt = bs + (kt % kStagesW) * kBK * BS;
    const int nsub = min(kBK / 32, (kend - kbeg - kt * kBK + 31) / 32);
    const int mr = warp * 16;
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      if (s >= nsub) break;
      // pixels 32s .. 32s + 31 of the staged tiles
      const unsigned char* ak = at + 32 * s * AS;
      const unsigned char* bk = bt + 32 * s * BS;
      Frag16 bf[BN / 16];
#pragma unroll
      for (int q = 0; q < BN / 16; ++q)
        bf[q] = frag16_ldsm(bk, BS, 16 * q, lane);
      if (m0 + mr < p.m) {
        const Frag16 af = frag16_ldsm(ak, AS, mr, lane);
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
  // addresses of the output: a row-major [kBM, BN] tile of int32.
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
  for (int i = tid; i < kBM * BN; i += kThreads) {
    const int row = m0 + i / BN, col = n0 + i % BN;
    if (row >= p.m || col >= p.cout || tile[i] == 0) continue;
    atomicAdd(p.out + static_cast<int64_t>(row) * p.cout + col,
              static_cast<unsigned long long>(
                  static_cast<long long>(tile[i])));
  }
}

template <int BN>
cudaError_t launch_wgrad(WgradArgs a, cudaStream_t stream) {
  const int smem = kStagesW * kBK * (tn_stride<kBM>() + tn_stride<BN>());
  cudaError_t err = allow_smem(conv_wgrad_kernel<BN>, smem);
  if (err != cudaSuccess) return err;
  const int mt = (a.m + kBM - 1) / kBM;
  const int nt = (a.cout + BN - 1) / BN;
  // pixel splits for ~2 blocks per SM, more where a chunk would pass
  // kChunk pixels; whole stages
  int splits = max((kTargetBlocks + mt * nt - 1) / (mt * nt),
                   (a.npix + kChunk - 1) / kChunk);
  int chunk = (a.npix + splits - 1) / splits;
  chunk = ((chunk + kBK - 1) / kBK) * kBK;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  splits = (a.npix + chunk - 1) / chunk;
  if (splits > 65535) return cudaErrorInvalidValue;
  a.chunk = chunk;
  const dim3 grid(mt, nt, splits);
  conv_wgrad_kernel<BN><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  dims: b, h, w, cin, ho, wo, cout, kh, kw, sh,
// sw, ph, pw (the pads' top and left).  Both require cin and cout
// multiples of 16, 16-byte aligned operands, b, h, w, ho, wo, kh, kw, sh,
// sw >= 1, ph, pw >= 0 and ho, wo the conv's output size.  Return
// cudaGetLastError() after the launches (0 = cudaSuccess).

// out [B,H,W,Cin]: f32 when inv is non-null, int32 otherwise; every
// element written.
extern "C" int lbt_conv_dgrad(const void* g, const void* w, void* out,
                              const void* inv, const int* dims,
                              void* stream) {
  DgradArgs a;
  a.g = static_cast<const int8_t*>(g);
  a.w = static_cast<const int8_t*>(w);
  a.out = out;
  a.inv = static_cast<const float*>(inv);
  a.b = dims[0]; a.h = dims[1]; a.w_ = dims[2]; a.cin = dims[3];
  a.ho = dims[4]; a.wo = dims[5]; a.cout = dims[6];
  const int kh = dims[7];
  a.kw = dims[8]; a.sh = dims[9]; a.sw = dims[10];
  const int ph = dims[11], pw = dims[12];
  if (a.b < 1 || a.h < 1 || a.w_ < 1 || a.cin % 16 || a.cout % 16 ||
      a.cin < 16 || a.cout < 16 || kh < 1 || a.kw < 1 || a.sh < 1 ||
      a.sw < 1 || ph < 0 || pw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  a.nclass = 0;
  int tiles = 0;
  for (int rh = 0; rh < a.sh && rh < a.h; ++rh) {
    for (int rw = 0; rw < a.sw && rw < a.w_; ++rw) {
      DgradClass& c = a.cls[a.nclass];
      c.rh = rh; c.rw = rw;
      c.hc = (a.h - rh + a.sh - 1) / a.sh;
      c.wc = (a.w_ - rw + a.sw - 1) / a.sw;
      c.i0 = (rh + ph) % a.sh;
      c.j0 = (rw + pw) % a.sw;
      c.nth = c.i0 < kh ? (kh - c.i0 + a.sh - 1) / a.sh : 0;
      c.ntw = c.j0 < a.kw ? (a.kw - c.j0 + a.sw - 1) / a.sw : 0;
      c.dh0 = (rh + ph - c.i0) / a.sh;
      c.dw0 = (rw + pw - c.j0) / a.sw;
      c.tile0 = tiles;
      tiles += static_cast<int>(
          (static_cast<int64_t>(a.b) * c.hc * c.wc + kBMD - 1) / kBMD);
      if (++a.nclass == kMaxClasses) {  // strides past 4 x 4: more launches
        const cudaError_t err = launch_dgrad_classes(a, tiles, st);
        if (err != cudaSuccess) return static_cast<int>(err);
        a.nclass = 0;
        tiles = 0;
      }
    }
  }
  if (a.nclass == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_dgrad_classes(a, tiles, st));
}

// out [kh*kw*Cin, Cout] int64, zeroed by the caller, += dW.  Requires the
// pixels B*Ho*Wo in 65535 splits of at most 2^16.
extern "C" int lbt_conv_wgrad(const void* x, const void* g, void* out,
                              const int* dims, void* stream) {
  WgradArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.g = static_cast<const int8_t*>(g);
  a.out = static_cast<unsigned long long*>(out);
  a.b = dims[0]; a.h = dims[1]; a.w_ = dims[2]; a.cin = dims[3];
  a.ho = dims[4]; a.wo = dims[5]; a.cout = dims[6];
  const int kh = dims[7];
  a.kw = dims[8]; a.sh = dims[9]; a.sw = dims[10];
  a.ph = dims[11]; a.pw = dims[12];
  if (a.b < 1 || a.ho < 1 || a.wo < 1 || a.cin % 16 || a.cout % 16 ||
      a.cin < 16 || a.cout < 16 || kh < 1 || a.kw < 1 || a.sh < 1 ||
      a.sw < 1 || a.ph < 0 || a.pw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.m = kh * a.kw * a.cin;
  a.npix = a.b * a.ho * a.wo;
  a.chunk = 0;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.cout <= 16) {
    err = launch_wgrad<16>(a, st);
  } else if (a.cout <= 32) {
    err = launch_wgrad<32>(a, st);
  } else {
    err = launch_wgrad<64>(a, st);
  }
  return static_cast<int>(err);
}
