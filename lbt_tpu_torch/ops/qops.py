"""Quantized matmul / conv2d forward on integer codes (PyTorch port of
``lbt_tpu/ops/qops.py``, ``engine='int8'``).

Both operands are quantized by K1 to integer codes, contracted by K2 (the
hand-written int8 GEMM, exact int32 accumulation) and dequantized by the
product of the two power-of-two multipliers — bit-identical to
``lbt_tpu``'s integer engine.

* ``qmatmul``: K1 on x and w, K2 with the ``1/(mx*mw)`` epilogue — the
  counterpart of ``qmatmul_pallas``.
* ``qconv2d``: NHWC x HWIO.  K1 on x and w, a plain-torch im2col of the
  int8 codes into ``[B*Ho*Wo, kh*kw*Cin]`` (zero codes in the padding,
  which is where zero inputs quantize to), then K2 against
  ``W.reshape(kh*kw*Cin, Cout)``.
* 9-bit activation codes (conv activations at ``bits_a + 1``) take the
  split-9 route of ``_conv_fwd_9split``: ``c = 2h + l`` with
  ``h = floor(c/2)`` in int8 and ``l`` in {0, 1}; two K2 calls return
  int32, combined as ``2a + b`` in int32, then scaled to f32.  Exact by
  construction.

Deterministic rounding only (serving); the custom backward and the
stochastic training path are not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from lbt_tpu_torch.dfxp.quantize import Exp, quantize_int
from lbt_tpu_torch.ops.kernels.gemm import int8_matmul

Pads = Tuple[Tuple[int, int], ...]


def conv_same_padding(in_size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF-style 'SAME' padding (lo, hi) for one spatial dim."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + k - in_size, 0)
    lo = total // 2
    return lo, total - lo


def conv_pads(padding, in_sizes: Sequence[int], ks: Sequence[int],
              strides: Sequence[int]) -> Pads:
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return tuple(conv_same_padding(i, k, s)
                         for i, k, s in zip(in_sizes, ks, strides))
        if padding.upper() == "VALID":
            return tuple((0, 0) for _ in in_sizes)
        raise ValueError(f"bad padding {padding!r}")
    return tuple(tuple(p) for p in padding)


def _check_widths(bits_x: int, bits_w: int, max_bits_x: int) -> None:
    if bits_w > 8 or bits_x > max_bits_x:
        raise NotImplementedError(
            f"code widths x{bits_x} w{bits_w} need lbt_tpu's float "
            f"fallback, which is not ported (int8 engine: w <= 8 bits, "
            f"x <= {max_bits_x} bits)")


def qmatmul(x: torch.Tensor, w: torch.Tensor, exp_x: Exp, exp_w: Exp, *,
            bits_x: int, bits_w: int) -> torch.Tensor:
    """Quantized ``x @ w`` for ``[M, K] @ [K, N]``, both operands at most
    8-bit codes; f32 result."""
    _check_widths(bits_x, bits_w, 8)
    xc, mx = quantize_int(x, bits_x, exp_x)
    wc, mw = quantize_int(w, bits_w, exp_w)
    return int8_matmul(xc, wc, (1.0 / (mx * mw)).reshape(1))


def _out_hw(h: int, w: int, ksize, strides, pads: Pads) -> Tuple[int, int]:
    return ((h + sum(pads[0]) - ksize[0]) // strides[0] + 1,
            (w + sum(pads[1]) - ksize[1]) // strides[1] + 1)


def im2col(codes: torch.Tensor, ksize: Tuple[int, int],
           strides: Tuple[int, int], pads: Pads) -> torch.Tensor:
    """NHWC codes -> ``[B*Ho*Wo, kh*kw*C]`` patches, columns ordered
    ``(i, j, c)`` to match an HWIO kernel flattened to ``[kh*kw*C, Cout]``.
    Padding positions hold zero codes."""
    b, h, w, c = codes.shape
    (kh, kw), (sh, sw) = ksize, strides
    (plo, phi), (qlo, qhi) = pads
    ho, wo = _out_hw(h, w, ksize, strides, pads)
    if plo or phi or qlo or qhi:
        xp = codes.new_zeros((b, h + plo + phi, w + qlo + qhi, c))
        xp[:, plo:plo + h, qlo:qlo + w] = codes
    else:
        xp = codes
    taps = [xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c)


def qconv2d(x: torch.Tensor, w: torch.Tensor, exp_x: Exp, exp_w: Exp, *,
            strides: Tuple[int, int], padding, bits_x: int,
            bits_w: int) -> torch.Tensor:
    """Quantized 2-d convolution, NHWC activations x HWIO weights; f32
    NHWC result.  Activations up to 9-bit codes, weights up to 8."""
    _check_widths(bits_x, bits_w, 9)
    strides = tuple(strides)
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    pads = conv_pads(padding, (h, wd), (kh, kw), strides)
    xc, mx = quantize_int(x, bits_x, exp_x)
    wc, mw = quantize_int(w, bits_w, exp_w)
    w2 = wc.reshape(kh * kw * cin, cout)
    inv = (1.0 / (mx * mw)).reshape(1)
    if bits_x <= 8:
        y = int8_matmul(im2col(xc, (kh, kw), strides, pads), w2, inv)
    else:  # split-9: c = 2h + l
        hi = xc >> 1
        lo = (xc - 2 * hi).to(torch.int8)
        a = int8_matmul(im2col(hi.to(torch.int8), (kh, kw), strides, pads),
                        w2)
        lo_acc = int8_matmul(im2col(lo, (kh, kw), strides, pads), w2)
        y = (2 * a + lo_acc).to(torch.float32) * inv
    return y.view(b, *_out_hw(h, wd, (kh, kw), strides, pads), cout)
