"""The bytes and operations one kernel call must move and do, and the least
time an NVIDIA H100 could take for them (its roofline bound).

Each input byte counts once and each output byte once, as the kernel takes
and gives them (im2col'd matrices where the callers pass those), whatever
the kernel reads again.  Operations are those the function needs on its
inputs' type: ``2*M*N*K`` int8 ops for a GEMM; for a conv of 9-bit (int16)
codes, twice the int8 ops, since the tensor cores take them as two split-9
int8 planes; five f32 operations an element for K1's quantize (scale, add
the noise, two clips, round).  Stochastic rounding adds the fewest integer
instructions its noise can take an element (:data:`NOISE_INSTRUCTIONS`),
against the SMs' issue rate: every instruction takes one of the 4 warp
slots an SM issues a clock, whichever pipe runs it.  ``bound_ms`` is the
largest of bytes over the memory rate and each type's operations over its
peak rate (NVIDIA's H100 SXM data sheet, dense, at 700 W; the issue rate
from the SM count and the SM clock, which ``chip_smoke.py`` reads on the
card and passes in).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# a Hopper SM issues at most one warp instruction a clock from each of its
# four schedulers: 128 thread instructions a clock, on any pipe
ISSUE_LANES_PER_SM = 4 * 32


def issue_rate(sm_count: int = 132, sm_clock_hz: float = 1.98e9) -> float:
    """The card's instruction issue rate, thread instructions a second:
    4 warp slots x 32 lanes x SMs x SM clock (by default the H100 SXM's
    132 SMs at its 1,980 MHz maximum)."""
    return ISSUE_LANES_PER_SM * sm_count * sm_clock_hz


ISSUE_PER_S = issue_rate()

# The fewest integer instructions an element of each noise mode
# (csrc/dfxp.cuh) can take, none for the counter or the float's f32 ops,
# every constant folded into a 3-input IADD3/LOP3 where one exists and a
# shift with its or into one LEA.HI, so that no compiler emits fewer:
#   0: none, rounding to nearest;
#   1: the hash: the seed's xor and the first xorshift in SHF + LOP3
#      (the seed's own xorshift is made once), two more xorshifts (2
#      each), two multiplies, the bits' move into a float (1): 9;
#   2: hash1: the seed's xor, one xorshift, two multiplies, the move: 6;
#   3: threefry: 20 rounds of add, rotate (one funnel shift) and xor (60);
#      of the six key injections into the counter's two words, those into
#      x0 fold into the next round's IADD3 and those into x1 take one add
#      each (6), the last into x0 one more (1); the output's xor and its
#      shift-or (2): 69;
#   4: Philox4x32-10 (an unsafe_rbg key): 10 rounds of two 32x32 -> 64-bit
#      products (one IMAD.WIDE.U32 each) and two 3-input xors of a high
#      word, a counter word and a round key (one LOP3 each; the round keys
#      are the same for every thread, made once): 40 a block of four
#      words, 10 an element where one block serves four elements, as in
#      K1 and #4/#5 on the training step; the word's shift-or (1): 11.
NOISE_INSTRUCTIONS = {0: 0, 1: 9, 2: 6, 3: 69, 4: 11}


@dataclass(frozen=True)
class Work:
    bytes: int
    ops: int
    ops_per_s: float  # the card's peak for these operations' type
    int_ops: int = 0  # the noise's integer instructions
    int_ops_per_s: float = ISSUE_PER_S

    @property
    def bytes_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    @property
    def ops_ms(self) -> float:
        """The slower of the two operation types' times."""
        return max(self.ops / self.ops_per_s,
                   self.int_ops / self.int_ops_per_s) * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def quantize_work(numel: int, code_bytes: int, stats: bool,
                  noise_mode: int = 0,
                  int_ops_per_s: float = ISSUE_PER_S) -> Work:
    """K1: f32 in, codes out, the int32 exponent in, the f32 multiplier
    out, [min, max] out on request; the noise's integer instructions of
    ``noise_mode`` (0: none) an element."""
    return Work(numel * (4 + code_bytes) + 4 + 4 + (8 if stats else 0),
                5 * numel, F32_OPS_PER_S,
                NOISE_INSTRUCTIONS[noise_mode] * numel, int_ops_per_s)


def gemm_work(m: int, k: int, n: int, scaled: bool) -> Work:
    """K2's AB form: A [M,K] and B [K,N] int8 in, int32 or f32 [M,N] out
    (and the one-float scale in when ``scaled``)."""
    return Work(m * k + k * n + 4 * m * n + (4 if scaled else 0),
                2 * m * n * k, INT8_OPS_PER_S)


def gemm_tn_work(k: int, m: int, n: int) -> Work:
    """K2's X^T.g form: A [K,M] and B [K,N] int8 in, int64 [M,N] out."""
    return Work(k * (m + n) + 8 * m * n, 2 * m * n * k, INT8_OPS_PER_S)


def _lines_read(n_in: int, n_out: int, taps: int, stride: int,
                lo: int) -> int:
    """How many of ``n_in`` input rows (or columns) the ``n_out`` output
    rows read through ``taps`` taps at ``stride``, after ``lo`` rows of
    padding."""
    return len({o * stride + t - lo for o in range(n_out)
                for t in range(taps)} & set(range(n_in)))


def conv_fused_work(xshape: Sequence[int], x_bytes: int,
                    wshape: Sequence[int], strides: Sequence[int],
                    pads, noise_mode: int = 0,
                    int_ops_per_s: float = ISSUE_PER_S) -> Work:
    """#4 / #5: NHWC codes (``x_bytes`` each) and HWIO int8 weights in,
    the two scales in; int8 codes [B,Ho,Wo,Cout], int64 moments [2,Cout]
    and f32 [min, max] out.  Only the input pixels some output reads
    count: a 1x1 conv at stride 2 reads a quarter of its input (a pixel's
    codes are whole 32-byte sectors at the path's widths, so the others
    are never fetched).  ``pads`` is ``((top, bottom), (left, right))``;
    the epilogue's noise (``noise_mode``) costs its integer instructions
    an output element."""
    b, h, w, cin = xshape
    kh, kw, _, cout = wshape
    (sh, sw), ((pt, pb), (pl, pr)) = strides, pads
    ho, wo = (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1
    pixels = b * ho * wo
    read = (b * _lines_read(h, ho, kh, sh, pt) * _lines_read(w, wo, kw, sw, pl)
            * cin)
    nbytes = (read * x_bytes + math.prod(wshape) + 8
              + pixels * cout + 16 * cout + 8)
    ops = 2 * pixels * kh * kw * cin * cout * (2 if x_bytes == 2 else 1)
    return Work(nbytes, ops, INT8_OPS_PER_S,
                NOISE_INSTRUCTIONS[noise_mode] * pixels * cout, int_ops_per_s)


def _taps_read(n_in: int, n_out: int, taps: int, stride: int,
               lo: int) -> int:
    """The (output position, tap) pairs along one dim whose input
    position ``o * stride + t - lo`` lies inside the ``n_in`` inputs: the
    products a conv's backward needs there."""
    return sum(1 for o in range(n_out) for t in range(taps)
               if 0 <= o * stride + t - lo < n_in)


def conv_dgrad_work(gshape: Sequence[int], wshape: Sequence[int],
                    x_hw: Sequence[int], strides: Sequence[int], pads,
                    scaled: bool = True) -> Work:
    """The dgrad kernel: int8 cotangent codes [B,Ho,Wo,Cout] and HWIO
    weight codes in, f32 (``scaled``, with its one-float scale) or int32
    dx [B,H,W,Cin] out; the useful products only, those of a tap and an
    output pixel whose input pixel lies inside the image."""
    b, ho, wo, cout = gshape
    kh, kw, cin, _ = wshape
    (h, w), (sh, sw), ((pt, _), (pl, _)) = x_hw, strides, pads
    pairs = (_taps_read(h, ho, kh, sh, pt) * _taps_read(w, wo, kw, sw, pl))
    nbytes = (b * ho * wo * cout + math.prod(wshape) + 4 * b * h * w * cin
              + (4 if scaled else 0))
    return Work(nbytes, 2 * b * pairs * cin * cout, INT8_OPS_PER_S)


def conv_wgrad_work(xshape: Sequence[int], x_bytes: int,
                    gshape: Sequence[int], ksize: Sequence[int],
                    strides: Sequence[int], pads) -> Work:
    """The wgrad kernel: NHWC input codes (``x_bytes`` each; only the
    pixels some tap reads count) and int8 cotangent codes in, int64
    [kh*kw*Cin, Cout] out; the useful products, twice for 9-bit codes'
    two split-9 planes."""
    b, h, w, cin = xshape
    _, ho, wo, cout = gshape
    (kh, kw), (sh, sw), ((pt, _), (pl, _)) = ksize, strides, pads
    read = (b * _lines_read(h, ho, kh, sh, pt) * _lines_read(w, wo, kw, sw, pl)
            * cin)
    pairs = (_taps_read(h, ho, kh, sh, pt) * _taps_read(w, wo, kw, sw, pl))
    nbytes = read * x_bytes + b * ho * wo * cout + 8 * kh * kw * cin * cout
    return Work(nbytes, 2 * b * pairs * cin * cout * (2 if x_bytes == 2
                                                      else 1),
                INT8_OPS_PER_S)
