"""Quantized matmul / conv2d on integer codes, forward and backward
(PyTorch port of ``lbt_tpu/ops/qops.py``, ``engine='int8'``).

Forward: both operands are quantized by K1 to integer codes (with the
``[min, max]`` their controllers read, on request), contracted by K2 (the
hand-written int8 GEMM, exact int32 accumulation) and dequantized by the
product of the two power-of-two multipliers: bit-identical to
``lbt_tpu``'s integer engine.

* ``qmatmul``: ``[M, K] @ [K, N]``, the counterpart of ``qmatmul_pallas``.
* ``qconv2d``: NHWC x HWIO.  A plain-torch im2col of the codes into
  ``[B*Ho*Wo, kh*kw*Cin]`` (zero codes in the padding, which is where zero
  inputs quantize to), then K2 against ``W.reshape(kh*kw*Cin, Cout)``.
* 9-bit activation codes (conv activations at ``bits_a + 1``) take
  split-9: ``c = 2h + l`` with ``h = floor(c/2)`` in int8 and ``l`` in
  {0, 1}; two K2 calls, combined as ``2a + b`` in integers.  Exact by
  construction (``lbt_tpu``'s ``_conv_fwd_9split``).
* ``qconv2d_bn_input``: a conv whose output feeds a BatchNorm input site,
  through kernel #4 (3x3) or #5 (1x1): the conv and the BN site's
  stochastic quantize, code moments and min/max in one kernel.

Backward (``torch.autograd.Function``s; autograd never differentiates
through im2col or a float matmul).  The cotangent arrives on the
``(bits_g, exp_g)`` grid, placed there by the layer's barrier, so its
codes are recovered exactly and both contractions run on integers:

    dx = g . W^T                 K2 on a copy of W^T (dense)
    dx = im2col(dilate(g)) . W'  K2, W' the flipped HIO-transposed kernel
    dW = X^T . g                 K2's split-K X^T.g form, int64 sums

For 9-bit x the dW contraction is split-9 as well (``lbt_tpu`` contracts
it in bf16 with f32 sums, inexact past 2**24).  The straight-through
estimator passes the cotangent through the operand quantizers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from lbt_tpu_torch.dfxp.barrier import quantize_cotangent
from lbt_tpu_torch.dfxp.quantize import (Exp, KeyData, dequantize,
                                         multiplier, noise_seed,
                                         quantize_int)
from lbt_tpu_torch.ops.im2col import (conv_pads, conv_same_padding,
                                      dilate_pad, dx_pads, im2col, out_hw)
from lbt_tpu_torch.ops.kernels.conv_fused import conv1x1_fused, conv3x3_fused
from lbt_tpu_torch.ops.kernels.gemm import int8_matmul, int8_matmul_tn

__all__ = ["BNInput", "conv_pads", "conv_same_padding", "im2col", "qconv2d",
           "qconv2d_bn_input", "qmatmul"]

def _check_widths(bits_x: int, bits_w: int, max_bits_x: int) -> None:
    if bits_w > 8 or bits_x > max_bits_x:
        raise NotImplementedError(
            f"code widths x{bits_x} w{bits_w} need lbt_tpu's float "
            f"fallback, which is not ported (int8 engine: w <= 8 bits, "
            f"x <= {max_bits_x} bits)")


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _check_grad_width(bits_g: int) -> None:
    if bits_g > 8:
        raise NotImplementedError(
            f"bits_g={bits_g}: the integer backward needs cotangent codes "
            f"of at most 8 bits; lbt_tpu's float backward is not ported")


def _codes(t, bits, exp, key, stochastic, backend, stats):
    """``(codes, mult, minmax or None)`` of one operand."""
    out = quantize_int(t, bits, exp, key, stochastic=stochastic,
                       backend=backend, stats=stats)
    return out if stats else (*out, None)


def _recover_codes(g: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """int8 codes of a cotangent that lies on the (<= 8-bit) grid."""
    return torch.round(g.to(torch.float32) * mult).to(torch.int8)


def _split9(xc: torch.Tensor):
    """``c = 2h + l``: int8 planes ``h = floor(c/2)`` and ``l`` in {0, 1}."""
    hi = xc >> 1
    return hi.to(torch.int8), (xc - 2 * hi).to(torch.int8)


def _int_sum_to_f32(acc: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return acc.to(torch.float32) * inv


# ---------------------------------------------------------------------------
# quantized matmul
# ---------------------------------------------------------------------------


class _QMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, xc, wc, mx, mw, exp_g, bits_g):
        ctx.save_for_backward(xc, wc, mx, mw)
        ctx.exp_g, ctx.bits_g = exp_g, bits_g
        return int8_matmul(xc, wc, (1.0 / (mx * mw)).reshape(1))

    @staticmethod
    def backward(ctx, g):
        xc, wc, mx, mw = ctx.saved_tensors
        mg = multiplier(ctx.bits_g, ctx.exp_g, g.device)
        gc = _recover_codes(g, mg)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = int8_matmul(gc, wc.t().contiguous(),
                             (1.0 / (mg * mw)).reshape(1))
        if ctx.needs_input_grad[1]:
            dw = _int_sum_to_f32(int8_matmul_tn(xc, gc), 1.0 / (mx * mg))
        return dx, dw, None, None, None, None, None, None


def qmatmul(x: torch.Tensor, w: torch.Tensor, exp_x: Exp, exp_w: Exp, *,
            bits_x: int, bits_w: int, exp_g: Exp = 0, bits_g: int = 32,
            key_x: Optional[KeyData] = None,
            key_w: Optional[KeyData] = None, stochastic: bool = False,
            backend: str = "xla_hash", stats: bool = False):
    """Quantized ``x @ w`` for ``[M, K] @ [K, N]``, both operands at most
    8-bit codes; f32 result.  Differentiable when ``x`` or ``w`` requires
    grad: the cotangent must lie on the ``(bits_g, exp_g)`` grid.
    ``stats=True`` returns ``(y, minmax_x, minmax_w)``."""
    _check_widths(bits_x, bits_w, 8)
    xc, mx, mm_x = _codes(x, bits_x, exp_x, key_x, stochastic, backend,
                          stats)
    wc, mw, mm_w = _codes(w, bits_w, exp_w, key_w, stochastic, backend,
                          stats)
    if _wants_grad(x, w):
        _check_grad_width(bits_g)
        y = _QMatmul.apply(x, w, xc, wc, mx, mw, exp_g, bits_g)
    else:
        y = int8_matmul(xc, wc, (1.0 / (mx * mw)).reshape(1))
    return (y, mm_x, mm_w) if stats else y


# ---------------------------------------------------------------------------
# quantized conv2d
# ---------------------------------------------------------------------------


def _conv_forward(xc, wc, mx, mw, strides, pads) -> torch.Tensor:
    """f32 conv of NHWC codes (int8, or int16 through split-9) with HWIO
    int8 codes, as ``[B*Ho*Wo, Cout]``: exact integer sums times
    ``1/(mx*mw)``."""
    kh, kw, cin, cout = wc.shape
    w2 = wc.reshape(kh * kw * cin, cout)
    inv = (1.0 / (mx * mw)).reshape(1)
    if xc.dtype == torch.int8:
        return int8_matmul(im2col(xc, (kh, kw), strides, pads), w2, inv)
    hi, lo = _split9(xc)
    acc = (2 * int8_matmul(im2col(hi, (kh, kw), strides, pads), w2)
           + int8_matmul(im2col(lo, (kh, kw), strides, pads), w2))
    return _int_sum_to_f32(acc, inv)


def _conv_backward(gc, mg, xc, wc, mx, mw, strides, pads, need_dx, need_dw):
    """``(dx, dW)`` of a conv from the cotangent's int8 codes ``gc``
    ``[B, Ho, Wo, Cout]`` (``None`` where not needed)."""
    b, h, w, cin = xc.shape
    kh, kw, _, cout = wc.shape
    dx = dw = None
    if need_dx:
        gd = dilate_pad(gc, strides, dx_pads(
            (h, w), (kh, kw), strides, pads, gc.shape[1:3]))
        wflip = wc.flip((0, 1)).permute(0, 1, 3, 2).contiguous().reshape(
            kh * kw * cout, cin)
        dx = int8_matmul(im2col(gd, (kh, kw), (1, 1), ((0, 0), (0, 0))),
                         wflip, (1.0 / (mg * mw)).reshape(1)).view(
                             b, h, w, cin)
    if need_dw:
        g2 = gc.reshape(-1, cout)
        if xc.dtype == torch.int8:
            acc = int8_matmul_tn(im2col(xc, (kh, kw), strides, pads), g2)
        else:
            hi, lo = _split9(xc)
            acc = (2 * int8_matmul_tn(im2col(hi, (kh, kw), strides, pads), g2)
                   + int8_matmul_tn(im2col(lo, (kh, kw), strides, pads), g2))
        dw = _int_sum_to_f32(acc, 1.0 / (mx * mg)).view(kh, kw, cin, cout)
    return dx, dw


class _QConv2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, xc, wc, mx, mw, exp_g, opts):
        bits_g, strides, pads = opts
        ctx.save_for_backward(xc, wc, mx, mw)
        ctx.exp_g, ctx.opts = exp_g, opts
        b, h, wd, _ = xc.shape
        y = _conv_forward(xc, wc, mx, mw, strides, pads)
        return y.view(b, *out_hw(h, wd, wc.shape[:2], strides, pads),
                      wc.shape[3])

    @staticmethod
    def backward(ctx, g):
        xc, wc, mx, mw = ctx.saved_tensors
        bits_g, strides, pads = ctx.opts
        mg = multiplier(bits_g, ctx.exp_g, g.device)
        dx, dw = _conv_backward(_recover_codes(g, mg), mg, xc, wc, mx, mw,
                                strides, pads, ctx.needs_input_grad[0],
                                ctx.needs_input_grad[1])
        return dx, dw, None, None, None, None, None, None


def qconv2d(x: torch.Tensor, w: torch.Tensor, exp_x: Exp, exp_w: Exp, *,
            strides: Tuple[int, int], padding, bits_x: int, bits_w: int,
            exp_g: Exp = 0, bits_g: int = 32,
            key_x: Optional[KeyData] = None,
            key_w: Optional[KeyData] = None, stochastic: bool = False,
            backend: str = "xla_hash", stats: bool = False):
    """Quantized 2-d convolution, NHWC activations x HWIO weights; f32
    NHWC result.  Activations up to 9-bit codes, weights up to 8.
    Differentiable as :func:`qmatmul`; ``stats=True`` returns ``(y,
    minmax_x, minmax_w)``."""
    _check_widths(bits_x, bits_w, 9)
    strides = tuple(strides)
    pads = conv_pads(padding, x.shape[1:3], w.shape[0:2], strides)
    xc, mx, mm_x = _codes(x, bits_x, exp_x, key_x, stochastic, backend,
                          stats)
    wc, mw, mm_w = _codes(w, bits_w, exp_w, key_w, stochastic, backend,
                          stats)
    if _wants_grad(x, w):
        _check_grad_width(bits_g)
    y = _QConv2d.apply(x, w, xc, wc, mx, mw, exp_g, (bits_g, strides, pads))
    return (y, mm_x, mm_w) if stats else y


# ---------------------------------------------------------------------------
# conv -> BatchNorm input, fused (kernels #4 and #5)
# ---------------------------------------------------------------------------


class BNInput(NamedTuple):
    """What :func:`qconv2d_bn_input` returns.  ``xq`` (f32, the
    dequantized BN input codes) carries the gradient; the rest does not."""
    xq: torch.Tensor        # codes / mult, NHWC
    codes: torch.Tensor     # int8 NHWC codes at the BN input site
    mult: torch.Tensor      # their multiplier
    moments: torch.Tensor   # int64 [2, Cout]: sum codes, sum codes^2
    minmax: torch.Tensor    # f32 [min, max] of the conv output
    minmax_x: Optional[torch.Tensor]  # the conv's operand statistics
    minmax_w: Optional[torch.Tensor]


class _ConvBNInput(torch.autograd.Function):
    """Forward: kernel #4 / #5.  Backward: the BN input site's STE, the
    carrier's rounding of the cotangent, the conv's cotangent barrier
    (quantize + overflow stats into the conv's sink) and the integer conv
    backward."""

    @staticmethod
    def forward(ctx, x, w, sink, xc, wc, mx, mw, mult_out, opts):
        strides, pads, bits_out, seed, light, carrier, barrier = opts
        ctx.save_for_backward(xc, wc, mx, mw)
        ctx.opts, ctx.has_sink = opts, sink is not None
        fused = conv3x3_fused if wc.shape[0] == 3 else conv1x1_fused
        codes, moments, minmax = fused(
            xc, wc, (1.0 / (mx * mw)).reshape(1), mult_out.reshape(1),
            strides=strides, pads=pads, bits_out=bits_out, seed=seed,
            light=light, round_bf16=carrier == torch.bfloat16)
        ctx.mark_non_differentiable(codes, moments, minmax)
        return dequantize(codes, mult_out), codes, moments, minmax

    @staticmethod
    def backward(ctx, g, *_):
        xc, wc, mx, mw = ctx.saved_tensors
        strides, pads, _, _, _, carrier, (bits_g, exp_g, key_g, kw) = \
            ctx.opts
        # the cotangent crosses the carrier between the conv and the BN
        # site, as the unfused route's two casts round it
        g = g.to(carrier).to(torch.float32)
        gc, mg, stats = quantize_cotangent(g, bits_g, exp_g, key_g, **kw)
        dx, dw = _conv_backward(gc, mg, xc, wc, mx, mw, strides, pads,
                                ctx.needs_input_grad[0],
                                ctx.needs_input_grad[1])
        return (dx, dw, stats if ctx.has_sink else None, None, None, None,
                None, None, None)


def fusable(ksize, bits_out: int) -> bool:
    """Whether :func:`qconv2d_bn_input` has a kernel for this conv."""
    return tuple(ksize[:2]) in ((3, 3), (1, 1)) and bits_out <= 8


def qconv2d_bn_input(
    x: torch.Tensor, w: torch.Tensor, exp_x: Exp, exp_w: Exp, *,
    strides: Tuple[int, int], padding, bits_x: int, bits_w: int,
    bits_out: int, exp_out: Exp, key_out: Optional[KeyData] = None,
    bits_g: int = 8, exp_g: Exp = 0, key_g: Optional[KeyData] = None,
    sink: Optional[torch.Tensor] = None, key_x: Optional[KeyData] = None,
    key_w: Optional[KeyData] = None, stochastic: bool = False,
    backend: str = "xla_hash", target_overflow_rate: float = 0.0,
    gate: bool = True, stats: bool = False,
    carrier: torch.dtype = torch.float32,
) -> BNInput:
    """A bias-free quantized conv followed by the next site's quantize at
    ``(bits_out, exp_out, key_out)``, in one kernel: the BN input's codes,
    moments and the conv output's min / max, without the f32 conv output.

    Equals ``quantize_int(qconv2d(x, w, ...).to(carrier), bits_out,
    exp_out, key_out)`` bit for bit: with a bfloat16 ``carrier`` the conv
    output is rounded to it first, and ``minmax`` is of the rounded
    output.  In the backward the cotangent of ``xq`` passes the BN site's
    STE, is rounded to ``carrier``, then passes the conv's barrier at
    ``(bits_g, exp_g, key_g)`` (statistics into ``sink``, or the hold
    sentinel when ``gate`` is off), then the integer conv backward.
    ``stats=True`` also returns the conv operands' ``[min, max]``."""
    _check_widths(bits_x, bits_w, 9)
    if not fusable(w.shape, bits_out):
        raise NotImplementedError(
            f"no fused kernel for a {tuple(w.shape[:2])} conv into "
            f"{bits_out}-bit codes")
    strides = tuple(strides)
    pads = conv_pads(padding, x.shape[1:3], w.shape[0:2], strides)
    xc, mx, mm_x = _codes(x, bits_x, exp_x, key_x, stochastic, backend,
                          stats)
    wc, mw, mm_w = _codes(w, bits_w, exp_w, key_w, stochastic, backend,
                          stats)
    if _wants_grad(x, w):
        _check_grad_width(bits_g)
    mult_out = multiplier(bits_out, exp_out, x.device)
    seed, light = noise_seed(key_out, stochastic, backend)
    barrier = (bits_g, exp_g, key_g,
               dict(stochastic=stochastic, backend=backend,
                    target_overflow_rate=target_overflow_rate,
                    gate=bool(gate)))
    xq, codes, moments, minmax = _ConvBNInput.apply(
        x, w, sink, xc, wc, mx, mw, mult_out,
        (strides, pads, bits_out, seed, light, carrier, barrier))
    return BNInput(xq, codes, mult_out, moments, minmax, mm_x, mm_w)
