"""The bytes and operations one kernel call must move and do, and the least
time an NVIDIA H100 could take for them (its roofline bound).

Each input byte counts once and each output byte once, as the kernel takes
and gives them (im2col'd matrices where the callers pass those), whatever
the kernel reads again.  Operations are those the function needs on its
inputs' type: ``2*M*N*K`` int8 ops for a GEMM; for a conv of 9-bit (int16)
codes, twice the int8 ops, since the tensor cores take them as two split-9
int8 planes; five f32 operations an element for K1's quantize (scale, add
the noise, two clips, round).  ``bound_ms`` is the larger of bytes over the
memory rate and operations over the peak rate of their type (NVIDIA's H100
SXM data sheet, dense, at 700 W).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12


@dataclass(frozen=True)
class Work:
    bytes: int
    ops: int
    ops_per_s: float  # the card's peak for these operations' type

    @property
    def bytes_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    @property
    def ops_ms(self) -> float:
        return self.ops / self.ops_per_s * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def quantize_work(numel: int, code_bytes: int, stats: bool) -> Work:
    """K1: f32 in, codes out, the int32 exponent in, the f32 multiplier
    out, [min, max] out on request."""
    return Work(numel * (4 + code_bytes) + 4 + 4 + (8 if stats else 0),
                5 * numel, F32_OPS_PER_S)


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
                    pads) -> Work:
    """#4 / #5: NHWC codes (``x_bytes`` each) and HWIO int8 weights in,
    the two scales in; int8 codes [B,Ho,Wo,Cout], int64 moments [2,Cout]
    and f32 [min, max] out.  Only the input pixels some output reads
    count: a 1x1 conv at stride 2 reads a quarter of its input (a pixel's
    codes are whole 32-byte sectors at the path's widths, so the others
    are never fetched).  ``pads`` is ``((top, bottom), (left, right))``."""
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
    return Work(nbytes, ops, INT8_OPS_PER_S)
