"""Quantized matmul / conv2d, forward and backward (PyTorch port of
``lbt_tpu/ops/qops.py``), on the route ``lbt_tpu`` takes for the engine
and the code widths.

The integer route (``engine='int8'`` or ``'pallas'``, both widths within
9 bits): both operands are quantized by K1 to integer codes (with the
``[min, max]`` their controllers read, on request), contracted by K2 (the
hand-written int8 GEMM, exact int32 accumulation) and dequantized by the
product of the two power-of-two multipliers: bit-identical to
``lbt_tpu``'s integer engine.

The float route (``engine='sim'`` / ``'sim_bf16'``, a 32-bit operand, or
widths past 9 bits: ``lbt_tpu``'s fake-quant route and its float
fallback): each operand fake-quantized by K1 with a straight-through
gradient, then one float contraction, ``torch.matmul`` / ``F.conv2d``
(cuBLAS / cuDNN on the card), differentiated by autograd.  ``sim`` and
the fallback contract in f32 under the process's TF32 setting, which the
entry points turn off for their calls (``utils.device.full_f32``), so
their f32 contractions are full f32; ``sim_bf16`` rounds both
operands to bf16 and the product to bf16 before it is upcast, as
``lbt_tpu``'s all-bf16 ``dot_general`` does, and its transposed
contractions in the backward stay bf16.  As in ``lbt_tpu``, this route
draws its operands' noise from ``jax.random.uniform``'s stream of the
key (``backend='xla'``: threefry, or Philox under an ``unsafe_rbg`` key)
whatever the configured ``noise_mode``.  The integer route's widths that K2 does not take (a
9-bit weight or dense operand) contract in f32 with the configured
stream: equal to ``lbt_tpu``'s bf16 integer contraction wherever its f32
sums are exact.

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

Backward of the integer route (``torch.autograd.Function``s; autograd
never differentiates through im2col or a float matmul).  The cotangent
arrives on the ``(bits_g, exp_g)`` grid, placed there by the layer's
barrier, so with ``bits_g <= 8`` its codes are recovered exactly and both
contractions run on integers:

    dx = g . W^T                 K2 on a copy of W^T (dense)
    dx = conv^T(g, W)            the dgrad kernel, taps gathered in place
    dW = X^T . g                 K2's split-K X^T.g form, int64 sums (dense)
    dW = conv^T(X, g)            the wgrad kernel, its split-K sums

A conv whose channel counts are not multiples of 16 (the RGB stem) takes
K2 over im2col patches instead: of the zero-dilated cotangent against the
flipped HIO-transposed kernel for ``dx``, of ``X`` for ``dW``.

For 9-bit x the dW contraction is split-9 as well (``lbt_tpu`` contracts
it in bf16 with f32 sums, inexact past 2**24).  Wider cotangents (and
none quantized, ``bits_g = 32``) take ``lbt_tpu``'s float backward, ``dx =
g . Wq^T`` and ``dW = Xq^T . g`` in f32 on the dequantized codes.  The
straight-through estimator passes the cotangent through the operand
quantizers.

Tensor parallel (``shard``, a ``parallel.mesh.Shard``: this rank holds
columns ``col0..`` of ``W``), on either route: ``W``'s codes draw their
noise at their counters in the whole ``W`` (the column window), the
contraction gives this rank's output channels, and :func:`join` gathers
the model group's channels into the whole output; a conv fused with its
BN input joins the BN input's codes and moments.  Backward: the join
hands on this rank's columns of the cotangent (every rank holds the whole
one, so nothing is summed), ``dW`` is the slice's own, and ``dx`` is the
sum over the model group of each rank's partial contraction, once per
sharded layer.  The integer route adds the int32 partial sums before the
dequantize, so its ``dx`` is the one-rank ``dx`` bit for bit; its float
backward (``bits_g > 8``) sums the f32 partials.  The float route puts
:class:`_ReduceGrad` on ``x`` before its fake-quant, so the STE and
everything upstream see the summed gradient: f32 partials summed in f32.
A float ``dx`` therefore adds the partials in another order than one
rank's contraction: f32 tolerance, not bitwise.

``sim_bf16`` contracts through :class:`_BF16Contract`, sharded or not:
bf16 operands into a bf16 product whose sums are exact wherever they fit
f32 (8-bit codes), as ``lbt_tpu``'s bf16 dot with f32 sums.  A sharded
layer's partial ``dx`` stays f32 and its sum over the model group is
rounded once to bf16, where one rank's product rounds, so ``sim_bf16``
at tp = 2 equals one rank's step up to the order of the f32 sums
(``lbt_tpu``'s GSPMD step instead all-reduces the ranks' bf16-rounded
partials as bf16, rounding twice).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from lbt_tpu_torch.config import INT_ENGINES
from lbt_tpu_torch.dfxp.barrier import quantize_cotangent
from lbt_tpu_torch.dfxp.quantize import (Exp, KeyData, dequantize,
                                         multiplier, noise_spec,
                                         quantize_int, quantize_ste)
from lbt_tpu_torch.ops.im2col import (conv_pads, conv_same_padding,
                                      dilate_pad, dx_pads, im2col, out_hw)
from lbt_tpu_torch.ops.kernels.conv_bwd import (implicit, int8_conv_dgrad,
                                               int8_conv_wgrad)
from lbt_tpu_torch.ops.kernels.conv_fused import conv1x1_fused, conv3x3_fused
from lbt_tpu_torch.ops.kernels.gemm import (int8_matmul, int8_matmul_tn,
                                           split9)

__all__ = ["BNInput", "conv_pads", "conv_same_padding", "im2col",
           "int_route", "qconv2d", "qconv2d_bn_input", "qmatmul"]


def int_route(engine: str, bits_x: int, bits_w: int) -> bool:
    """Whether ``lbt_tpu`` contracts these operands on integer codes: an
    integer engine and both widths within 9 bits (its ``_code_dtype``).
    Otherwise it takes the fake-quant float route."""
    return engine in INT_ENGINES and max(bits_x, bits_w) <= 9


def _codes(t, bits, exp, key, stochastic, backend, shared, stats, row0=0,
           shard=None):
    """``(codes, mult, minmax or None)`` of one operand (a ``shard``'s
    columns of a weight draw their noise where the whole weight does)."""
    out = quantize_int(t, bits, exp, key, stochastic=stochastic,
                       backend=backend, noise_shared_axis0=shared,
                       stats=stats, row0=row0, window=_window(shard))
    return out if stats else (*out, None)


def _window(shard):
    return None if shard is None else (shard.col0, shard.n)


def join(t: torch.Tensor, shard) -> torch.Tensor:
    """The model group's column slices of a tensor joined along the last
    dim: each padded to ``ceil(n / tp)`` columns, all-gathered, the
    padding cut."""
    group = shard.group
    w = -(-shard.n // group.world)
    if t.shape[-1] < w:
        t = torch.cat([t, t.new_zeros((*t.shape[:-1], w - t.shape[-1]))],
                      -1)
    out = group.all_gather(t, -1, kind="gather")
    # slices are ceil(n / tp) wide but the last: the whole is out[..., :n]
    return out if out.shape[-1] == shard.n else \
        out[..., :shard.n].contiguous()


class _Join(torch.autograd.Function):
    """:func:`join` in the forward; the backward takes this rank's
    columns of the cotangent, which every rank of the model group holds
    whole: no sum over the group (that would scale the gradient by its
    size)."""

    @staticmethod
    def forward(ctx, t, shard):
        ctx.shard = shard
        return join(t, shard)

    @staticmethod
    def backward(ctx, g):
        s = ctx.shard
        return g[..., s.col0:s.col0 + s.width].contiguous(), None


def _joined(y: torch.Tensor, shard) -> torch.Tensor:
    """``y`` (this rank's output channels) joined through :class:`_Join`,
    or ``y`` itself when its layer is not sharded."""
    return y if shard is None else _Join.apply(y, shard)


def _float_conv(x, w, strides, pads) -> torch.Tensor:
    """NHWC x HWIO conv in the operands' dtype through ``F.conv2d``, with
    TF-style (lo, hi) pads; NHWC result."""
    (pt, pb), (pl, pr) = pads
    xn = x.permute(0, 3, 1, 2)
    if pt or pb or pl or pr:
        xn = F.pad(xn, (pl, pr, pt, pb))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=tuple(strides))
    return y.permute(0, 2, 3, 1).contiguous()


def _fake_quant(t, bits, exp, key, stats, kw):
    """``(tq, minmax or None)``: STE fake-quantize of one operand."""
    if stats and bits < 32:
        return quantize_ste(t, bits, exp, key, stats=True, **kw)
    return quantize_ste(t, bits, exp, key, **kw), None


class _ReduceGrad(torch.autograd.Function):
    """Identity in the forward.  In the backward the cotangent of ``x``,
    this rank's partial contraction with its columns of ``W``, summed
    over the model group ``tp`` in f32; with ``bf16`` the sum is rounded
    once to bf16, where one rank's bf16 product rounds."""

    @staticmethod
    def forward(ctx, x, tp, bf16):
        ctx.tp, ctx.bf16 = tp, bf16
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = ctx.tp.all_reduce(g.to(torch.float32), kind="dx")
        if ctx.bf16:
            total = total.to(torch.bfloat16)
        return total.to(g.dtype), None, None


def _dx_operands(g: torch.Tensor, w: torch.Tensor, x_hw, strides, pads):
    """The input gradient of an NHWC x HWIO conv as one GEMM's operands:
    the im2col of the lhs-dilated cotangent ``g`` and the flipped,
    HIO-transposed kernel ``w`` (``[kh*kw*Cout, Cin]``)."""
    kh, kw, cin, cout = w.shape
    gd = dilate_pad(g, strides, dx_pads(x_hw, (kh, kw), strides, pads,
                                        g.shape[1:3]))
    return (im2col(gd, (kh, kw), (1, 1), ((0, 0), (0, 0))),
            w.flip((0, 1)).permute(0, 1, 3, 2).contiguous().reshape(
                kh * kw * cout, cin))


class _BF16Contract(torch.autograd.Function):
    """``sim_bf16``'s contraction of ``x`` with ``W`` (a matmul, or a conv
    with ``geom = (strides, pads)``): the operands rounded to bf16 into a
    bf16 product whose sums are exact wherever they fit f32, as
    ``lbt_tpu``'s bf16 dot with f32 sums.  The library's bf16 calls are
    not all exact on the card (cuDNN's bf16 wgrad rounds partial sums at
    ResNet-50's 28x28 1x1 shapes, cuBLAS's bf16 GEMM at the head's
    500-column slice), so only the conv's forward is one (exact at every
    shape of ResNet-50); a matmul's forward is the f32 GEMM of the bf16
    values rounded once, the backward two f32 GEMMs (im2col for a conv:
    cuDNN's f32 dgrad is not exact at some 3x3 shapes), ``dW`` rounded
    once to bf16.  ``x``'s gradient is rounded once too, or with
    ``partial`` (this rank's columns of a sharded ``W``) left f32 for
    :class:`_ReduceGrad` to sum over the model group and round."""

    @staticmethod
    def forward(ctx, xq, wq, geom, partial):
        xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.geom, ctx.partial = geom, partial
        if geom is None:
            return (xb.to(torch.float32) @ wb.to(torch.float32)).to(
                torch.bfloat16)
        return _float_conv(xb, wb, *geom)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        x, w, g = (t.to(torch.float32) for t in (xb, wb, g))
        dx = dw = None
        if ctx.geom is None:
            if ctx.needs_input_grad[0]:
                dx = g @ w.t()
            if ctx.needs_input_grad[1]:
                dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(
                    -1, g.shape[-1])
        else:
            strides, pads = ctx.geom
            if ctx.needs_input_grad[0]:
                cols, wflip = _dx_operands(g, w, x.shape[1:3], strides, pads)
                dx = (cols @ wflip).view(x.shape)
            if ctx.needs_input_grad[1]:
                cols = im2col(x, w.shape[:2], strides, pads)
                dw = (cols.t() @ g.reshape(-1, g.shape[-1])).view(w.shape)
        if dx is not None and not ctx.partial:
            dx = dx.to(torch.bfloat16).to(torch.float32)
        if dw is not None:
            dw = dw.to(torch.bfloat16).to(torch.float32)
        return dx, dw, None, None


def _float_route(contract, x, w, exp_x, exp_w, *, bits_x, bits_w, key_x,
                 key_w, stochastic, backend, shared, stats, bf16, row0,
                 shard, geom=None):
    """Both operands fake-quantized (STE), then ``contract`` in f32, or
    with ``bf16`` :class:`_BF16Contract` (``geom``: a conv's ``(strides,
    pads)``, ``None`` for a matmul) into a bf16 product upcast after;
    autograd differentiates it.  With a ``shard`` ``w`` is its columns:
    they draw their noise through the window, the product (bf16 under
    ``bf16``) is joined over the model group, and ``x``'s gradient is
    summed over it (:class:`_ReduceGrad`)."""
    kw = dict(stochastic=stochastic, backend=backend,
              noise_shared_axis0=shared)
    if shard is not None and torch.is_grad_enabled() and x.requires_grad:
        x = _ReduceGrad.apply(x, shard.group, bf16)
    xq, mm_x = _fake_quant(x, bits_x, exp_x, key_x, stats,
                           dict(kw, row0=row0))
    wq, mm_w = _fake_quant(w, bits_w, exp_w, key_w, stats,
                           dict(kw, window=_window(shard)))
    if bf16:
        y = _joined(_BF16Contract.apply(xq, wq, geom, shard is not None),
                    shard).to(torch.float32)
    else:
        y = _joined(contract(xq.to(torch.float32), wq.to(torch.float32)),
                    shard)
    return (y, mm_x, mm_w) if stats else y


def _recover_codes(g: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """int8 codes of a cotangent that lies on the (<= 8-bit) grid."""
    return torch.round(g.to(torch.float32) * mult).to(torch.int8)


def _int_sum_to_f32(acc: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return acc.to(torch.float32) * inv


def _summed(dx: torch.Tensor, tp) -> torch.Tensor:
    """A float backward's partial ``dx`` summed over the model group
    ``tp`` (f32), or itself on one rank."""
    return dx if tp is None else tp.all_reduce(dx, kind="dx")


def _partial_dx(contract, inv: torch.Tensor, tp) -> torch.Tensor:
    """An integer contraction dequantized by ``inv``: ``contract(inv)``,
    the kernel with its epilogue, on one rank; under tensor parallelism
    each rank's int32 partial sum over its columns, ``contract(None)``,
    summed over the model group ``tp``, then dequantized (the same bits
    as one rank's epilogue)."""
    if tp is None:
        return contract(inv)
    return _int_sum_to_f32(tp.all_reduce(contract(None), kind="dx"), inv)


# ---------------------------------------------------------------------------
# quantized matmul
# ---------------------------------------------------------------------------


class _QMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, xc, wc, mx, mw, exp_g, bits_g, tp):
        ctx.save_for_backward(xc, wc, mx, mw)
        ctx.exp_g, ctx.bits_g, ctx.tp = exp_g, bits_g, tp
        return int8_matmul(xc, wc, (1.0 / (mx * mw)).reshape(1))

    @staticmethod
    def backward(ctx, g):
        xc, wc, mx, mw = ctx.saved_tensors
        dx = dw = None
        if ctx.bits_g > 8:  # lbt_tpu's float backward
            g = g.to(torch.float32)
            if ctx.needs_input_grad[0]:
                dx = _summed(g @ dequantize(wc, mw).t(), ctx.tp)
            if ctx.needs_input_grad[1]:
                dw = dequantize(xc, mx).t() @ g
            return dx, dw, None, None, None, None, None, None, None
        mg = multiplier(ctx.bits_g, ctx.exp_g, g.device)
        gc = _recover_codes(g, mg)
        if ctx.needs_input_grad[0]:
            wt = wc.t().contiguous()
            dx = _partial_dx(lambda inv: int8_matmul(gc, wt, inv),
                             (1.0 / (mg * mw)).reshape(1), ctx.tp)
        if ctx.needs_input_grad[1]:
            dw = _int_sum_to_f32(int8_matmul_tn(xc, gc), 1.0 / (mx * mg))
        return dx, dw, None, None, None, None, None, None, None


def qmatmul(x: torch.Tensor, w: torch.Tensor, exp_x: Exp, exp_w: Exp, *,
            bits_x: int, bits_w: int, exp_g: Exp = 0, bits_g: int = 32,
            engine: str = "int8", key_x: Optional[KeyData] = None,
            key_w: Optional[KeyData] = None, stochastic: bool = False,
            backend: str = "xla", noise_shared_axis0: bool = False,
            stats: bool = False, row0: int = 0, shard=None):
    """Quantized ``x @ w`` for ``[M, K] @ [K, N]`` on ``engine``'s route;
    f32 result.  Differentiable when ``x`` or ``w`` requires grad; on the
    integer route with ``bits_g <= 8`` the cotangent must lie on the
    ``(bits_g, exp_g)`` grid.  ``stats=True`` returns ``(y, minmax_x,
    minmax_w)`` (None for a 32-bit operand).  ``row0`` places ``x``'s
    rows in a larger batch's noise (``dfxp.quantize.noise_spec``).  With a
    ``shard`` ``w`` is its columns of the weight and ``y`` the whole
    output, joined over the model group (``minmax_w`` is the slice's)."""
    kw = dict(bits_x=bits_x, bits_w=bits_w, key_x=key_x, key_w=key_w,
              stochastic=stochastic, shared=noise_shared_axis0, stats=stats,
              row0=row0, shard=shard)
    if not int_route(engine, bits_x, bits_w):
        return _float_route(
            torch.matmul, x, w, exp_x, exp_w, backend="xla",
            bf16=engine == "sim_bf16" and max(bits_x, bits_w) < 32, **kw)
    if max(bits_x, bits_w) > 8:  # 9-bit codes: K2 takes int8 only
        return _float_route(torch.matmul, x, w, exp_x, exp_w,
                            backend=backend, bf16=False, **kw)
    xc, mx, mm_x = _codes(x, bits_x, exp_x, key_x, stochastic, backend,
                          noise_shared_axis0, stats, row0)
    wc, mw, mm_w = _codes(w, bits_w, exp_w, key_w, stochastic, backend,
                          noise_shared_axis0, stats, shard=shard)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _QMatmul.apply(x, w, xc, wc, mx, mw, exp_g, bits_g,
                           None if shard is None else shard.group)
    else:
        y = int8_matmul(xc, wc, (1.0 / (mx * mw)).reshape(1))
    y = _joined(y, shard)
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
    hi, lo = split9(xc)
    acc = (2 * int8_matmul(im2col(hi, (kh, kw), strides, pads), w2)
           + int8_matmul(im2col(lo, (kh, kw), strides, pads), w2))
    return _int_sum_to_f32(acc, inv)


def _im2col_dgrad(gc, wc, x_hw, strides, pads, inv=None) -> torch.Tensor:
    """:func:`int8_conv_dgrad` for any channel counts: K2 over the im2col
    of the zero-dilated, padded cotangent against the flipped,
    HIO-transposed kernel."""
    cols, wflip = _dx_operands(gc, wc, x_hw, strides, pads)
    return int8_matmul(cols, wflip, inv).view(gc.shape[0], *x_hw,
                                              wc.shape[2])


def _im2col_wgrad(xc, gc, ksize, strides, pads) -> torch.Tensor:
    """:func:`int8_conv_wgrad` for any channel counts: K2's X^T.g over the
    im2col of the input codes (split-9 planes for 9-bit codes)."""
    g2 = gc.reshape(-1, gc.shape[3])
    if xc.dtype == torch.int8:
        return int8_matmul_tn(im2col(xc, ksize, strides, pads), g2)
    hi, lo = split9(xc)
    return (2 * int8_matmul_tn(im2col(hi, ksize, strides, pads), g2)
            + int8_matmul_tn(im2col(lo, ksize, strides, pads), g2))


def _conv_backward(gc, mg, xc, wc, mx, mw, strides, pads, need_dx, need_dw,
                   tp=None):
    """``(dx, dW)`` of a conv from the cotangent's int8 codes ``gc``
    ``[B, Ho, Wo, Cout]`` (``None`` where not needed); under tensor
    parallelism ``wc`` and ``gc`` hold this rank's output channels, and
    ``dx`` sums the model group ``tp``'s partial contractions.  Channel
    counts that are multiples of 16 take the implicit-GEMM kernels, which
    gather the taps as they load; others (the RGB stem's ``Cin = 3``) K2
    over im2col patches."""
    _, h, w, cin = xc.shape
    kh, kw, _, cout = wc.shape
    if implicit(cin, cout):
        dgrad, wgrad = int8_conv_dgrad, int8_conv_wgrad
    else:
        dgrad, wgrad = _im2col_dgrad, _im2col_wgrad
    dx = dw = None
    if need_dx:
        dx = _partial_dx(
            lambda inv: dgrad(gc, wc, (h, w), strides, pads, inv),
            (1.0 / (mg * mw)).reshape(1), tp)
    if need_dw:
        acc = wgrad(xc, gc, (kh, kw), strides, pads)
        dw = _int_sum_to_f32(acc, 1.0 / (mx * mg)).view(kh, kw, cin, cout)
    return dx, dw


def _float_conv_backward(g, xq, wq, strides, pads, needs):
    """``(dx, dW)`` of the f32 conv of ``xq`` and ``wq`` for the
    cotangent ``g`` (None where ``needs`` is false): the transposed convs
    through autograd."""
    xq = xq.detach().requires_grad_(needs[0])
    wq = wq.detach().requires_grad_(needs[1])
    wrt = [t for t in (xq, wq) if t.requires_grad]
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(
            _float_conv(xq, wq, strides, pads), wrt, g.to(torch.float32)))
    return tuple(next(grads) if n else None for n in needs)


class _QConv2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, xc, wc, mx, mw, exp_g, opts):
        bits_g, strides, pads, _ = opts
        ctx.save_for_backward(xc, wc, mx, mw)
        ctx.exp_g, ctx.opts = exp_g, opts
        b, h, wd, _ = xc.shape
        y = _conv_forward(xc, wc, mx, mw, strides, pads)
        return y.view(b, *out_hw(h, wd, wc.shape[:2], strides, pads),
                      wc.shape[3])

    @staticmethod
    def backward(ctx, g):
        xc, wc, mx, mw = ctx.saved_tensors
        bits_g, strides, pads, tp = ctx.opts
        if bits_g > 8:  # lbt_tpu's float backward
            dx, dw = _float_conv_backward(
                g, dequantize(xc, mx), dequantize(wc, mw), strides, pads,
                ctx.needs_input_grad[:2])
            if dx is not None:
                dx = _summed(dx, tp)
            return dx, dw, None, None, None, None, None, None
        mg = multiplier(bits_g, ctx.exp_g, g.device)
        dx, dw = _conv_backward(_recover_codes(g, mg), mg, xc, wc, mx, mw,
                                strides, pads, ctx.needs_input_grad[0],
                                ctx.needs_input_grad[1], tp)
        return dx, dw, None, None, None, None, None, None


def qconv2d(x: torch.Tensor, w: torch.Tensor, exp_x: Exp, exp_w: Exp, *,
            strides: Tuple[int, int], padding, bits_x: int, bits_w: int,
            exp_g: Exp = 0, bits_g: int = 32, engine: str = "int8",
            key_x: Optional[KeyData] = None,
            key_w: Optional[KeyData] = None, stochastic: bool = False,
            backend: str = "xla", noise_shared_axis0: bool = False,
            stats: bool = False, row0: int = 0, shard=None):
    """Quantized 2-d convolution, NHWC activations x HWIO weights, on
    ``engine``'s route; f32 NHWC result.  The integer route contracts
    activations of up to 9-bit codes (split-9) with 8-bit weights.
    Differentiable as :func:`qmatmul`; ``stats=True`` returns ``(y,
    minmax_x, minmax_w)``; ``row0`` and ``shard`` as there."""
    strides = tuple(strides)
    pads = conv_pads(padding, x.shape[1:3], w.shape[0:2], strides)
    kw = dict(bits_x=bits_x, bits_w=bits_w, key_x=key_x, key_w=key_w,
              stochastic=stochastic, shared=noise_shared_axis0, stats=stats,
              row0=row0, shard=shard)

    def conv(a, b):
        return _float_conv(a, b, strides, pads)

    if not int_route(engine, bits_x, bits_w):
        return _float_route(
            conv, x, w, exp_x, exp_w, backend="xla",
            bf16=engine == "sim_bf16" and max(bits_x, bits_w) < 32,
            geom=(strides, pads), **kw)
    if bits_w > 8:  # 9-bit weight codes: K2 takes int8 only
        return _float_route(conv, x, w, exp_x, exp_w, backend=backend,
                            bf16=False, **kw)
    xc, mx, mm_x = _codes(x, bits_x, exp_x, key_x, stochastic, backend,
                          noise_shared_axis0, stats, row0)
    wc, mw, mm_w = _codes(w, bits_w, exp_w, key_w, stochastic, backend,
                          noise_shared_axis0, stats, shard=shard)
    y = _QConv2d.apply(x, w, xc, wc, mx, mw, exp_g,
                       (bits_g, strides, pads,
                        None if shard is None else shard.group))
    y = _joined(y, shard)
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
        strides, pads, bits_out, noise, carrier, barrier, shard = opts
        ctx.save_for_backward(xc, wc, mx, mw)
        ctx.opts, ctx.has_sink = opts, sink is not None
        fused = conv3x3_fused if wc.shape[0] == 3 else conv1x1_fused
        codes, moments, minmax = fused(
            xc, wc, (1.0 / (mx * mw)).reshape(1), mult_out.reshape(1),
            strides=strides, pads=pads, bits_out=bits_out, noise=noise,
            round_bf16=carrier == torch.bfloat16)
        if shard is not None:
            # BN is per channel: the whole BN input's codes and moments
            codes, moments = join(codes, shard), join(moments, shard)
        ctx.mark_non_differentiable(codes, moments, minmax)
        return dequantize(codes, mult_out), codes, moments, minmax

    @staticmethod
    def backward(ctx, g, *_):
        xc, wc, mx, mw = ctx.saved_tensors
        (strides, pads, _, _, carrier, (bits_g, exp_g, key_g, kw),
         shard) = ctx.opts
        # the cotangent crosses the carrier between the conv and the BN
        # site, as the unfused route's two casts round it
        g = g.to(carrier).to(torch.float32)
        # the barrier sees the whole cotangent; a shard's conv backward
        # takes its columns
        gc, mg, stats = quantize_cotangent(g, bits_g, exp_g, key_g, **kw)
        tp = None
        if shard is not None:
            gc = gc[..., shard.col0:shard.col0 + shard.width].contiguous()
            tp = shard.group
        dx, dw = _conv_backward(gc, mg, xc, wc, mx, mw, strides, pads,
                                ctx.needs_input_grad[0],
                                ctx.needs_input_grad[1], tp)
        return (dx, dw, stats if ctx.has_sink else None, None, None, None,
                None, None, None)


def fusable(ksize, bits_out: int, engine: str, bits_x: int, bits_w: int,
            bits_g: int) -> bool:
    """Whether :func:`qconv2d_bn_input` has a kernel for this conv: a
    3x3 or 1x1 conv on the integer route with codes the kernels take
    (activations of up to 9 bits, 8-bit weights, cotangent and output)."""
    return (tuple(ksize[:2]) in ((3, 3), (1, 1)) and bits_out <= 8
            and int_route(engine, bits_x, bits_w) and bits_w <= 8
            and bits_g <= 8)


def qconv2d_bn_input(
    x: torch.Tensor, w: torch.Tensor, exp_x: Exp, exp_w: Exp, *,
    strides: Tuple[int, int], padding, bits_x: int, bits_w: int,
    bits_out: int, exp_out: Exp, key_out: Optional[KeyData] = None,
    bits_g: int = 8, exp_g: Exp = 0, key_g: Optional[KeyData] = None,
    sink: Optional[torch.Tensor] = None, key_x: Optional[KeyData] = None,
    key_w: Optional[KeyData] = None, stochastic: bool = False,
    backend: str = "xla", noise_shared_axis0: bool = False,
    target_overflow_rate: float = 0.0, gate: bool = True,
    stats: bool = False, carrier: torch.dtype = torch.float32,
    row0: int = 0, shard=None,
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
    ``stats=True`` also returns the conv operands' ``[min, max]``;
    ``row0`` places ``x``'s and the output's rows in a larger batch's
    noise (``dfxp.quantize.noise_spec``).  With a ``shard`` ``w`` is its
    output columns: the kernel quantizes those channels of the BN input,
    drawing their noise where the whole tensor does, and the codes and
    moments returned are the model group's joined (``minmax`` and
    ``minmax_w`` are this rank's slice's)."""
    if not fusable(w.shape, bits_out, "int8", bits_x, bits_w, bits_g):
        raise NotImplementedError(
            f"no fused kernel for a {tuple(w.shape[:2])} conv of codes "
            f"x{bits_x} w{bits_w} g{bits_g} into {bits_out}-bit codes")
    strides = tuple(strides)
    pads = conv_pads(padding, x.shape[1:3], w.shape[0:2], strides)
    xc, mx, mm_x = _codes(x, bits_x, exp_x, key_x, stochastic, backend,
                          noise_shared_axis0, stats, row0)
    wc, mw, mm_w = _codes(w, bits_w, exp_w, key_w, stochastic, backend,
                          noise_shared_axis0, stats, shard=shard)
    mult_out = multiplier(bits_out, exp_out, x.device)
    out_shape = (x.shape[0], *out_hw(x.shape[1], x.shape[2], w.shape[:2],
                                     strides, pads), w.shape[3])
    noise = noise_spec(key_out, stochastic, backend, out_shape,
                       noise_shared_axis0, row0, _window(shard))
    barrier = (bits_g, exp_g, key_g,
               dict(stochastic=stochastic, backend=backend,
                    noise_shared_axis0=noise_shared_axis0,
                    target_overflow_rate=target_overflow_rate,
                    gate=bool(gate)))
    xq, codes, moments, minmax = _ConvBNInput.apply(
        x, w, sink, xc, wc, mx, mw, mult_out,
        (strides, pads, bits_out, noise, carrier, barrier, shard))
    return BNInput(xq, codes, mult_out, moments, minmax, mm_x, mm_w)
