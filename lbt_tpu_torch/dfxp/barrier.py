"""Gradient-quantization barrier (PyTorch port of ``lbt_tpu/dfxp/barrier.py``).

Identity in the forward pass.  In the backward pass it quantizes the
incoming cotangent at ``(bits, exp)`` with K1, which in the same pass
gives the ``[min, max]`` the overflow statistics need, and hands those
statistics out as the gradient of a *sink*: a zero ``(2,)`` leaf tensor
made with ``requires_grad=True`` (:func:`make_sink`).  After the backward
pass the train step reads each sink's ``.grad`` and steps the gradient
site's exponent (``absorb_sinks``), as ``lbt_tpu`` differentiates its zero
sinks.  The exponent read here is the one from before that update.
"""

from __future__ import annotations

from typing import Optional

import torch

from lbt_tpu_torch.dfxp.quantize import (Exp, KeyData, dequantize,
                                         overflow_indicators, overflow_rates,
                                         quantize_int)

__all__ = ["HOLD_STATS", "SINK_SHAPE", "grad_quant_barrier", "hold_stats",
           "make_sink", "quantize_cotangent"]

SINK_SHAPE = (2,)

# Statistics that make update_exponent hold: ovf = 0 (no widen), ovf2 = 1
# (no tighten).  Emitted on steps whose controllers are gated off.
HOLD_STATS = (0.0, 1.0)


def hold_stats(device) -> torch.Tensor:
    """:data:`HOLD_STATS` as a fresh f32 ``(2,)`` tensor made on
    ``device`` by one ``arange`` fill (0, 1), never from Python data: a
    CUDA tensor built from a tuple is a pageable copy that waits for the
    card.  Fresh, so the ``.grad`` that autograd keeps of it is no tensor
    that another sink shares."""
    return torch.arange(2, dtype=torch.float32, device=device)


def make_sink(device=None) -> torch.Tensor:
    """A fresh stat sink; after ``backward`` its ``.grad`` holds the
    overflow statistics of the cotangent that crossed its barrier."""
    return torch.zeros(SINK_SHAPE, device=device, requires_grad=True)


def quantize_cotangent(g: torch.Tensor, bits: int, exp: Exp,
                       key: Optional[KeyData], *, stochastic: bool,
                       backend: str, noise_shared_axis0: bool = False,
                       target_overflow_rate: float = 0.0,
                       gate: bool = True):
    """``(codes, multiplier, stats)`` of a cotangent: its DFXP codes and
    the overflow statistics of ``g`` at ``exp`` (the hold sentinel when
    ``gate`` is off)."""
    with_mm = gate and target_overflow_rate == 0.0
    out = quantize_int(g, bits, exp, key, stochastic=stochastic,
                       backend=backend,
                       noise_shared_axis0=noise_shared_axis0, stats=with_mm)
    if with_mm:
        stats = overflow_indicators(out[2], bits)
    elif gate:
        stats = overflow_rates(g, bits, exp)
    else:
        stats = hold_stats(g.device)
    return out[0], out[1], stats


class _Barrier(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, sink, exp, opts):
        ctx.exp = exp
        ctx.opts = opts
        ctx.has_sink = sink is not None
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        bits, key, kw = ctx.opts
        codes, mult, stats = quantize_cotangent(g, bits, ctx.exp, key, **kw)
        gq = dequantize(codes, mult).to(g.dtype)
        return gq, (stats if ctx.has_sink else None), None, None


def grad_quant_barrier(
    x: torch.Tensor,
    bits: int,
    exp: Exp,
    sink: Optional[torch.Tensor],
    key: Optional[KeyData] = None,
    *,
    stochastic: bool = False,
    backend: str = "xla",
    noise_shared_axis0: bool = False,
    target_overflow_rate: float = 0.0,
    gate: bool = True,
) -> torch.Tensor:
    """Identity forward; the backward quantizes the cotangent at
    ``(bits, exp)`` and emits its overflow statistics as the gradient of
    ``sink``.  ``gate=False`` skips the statistics and emits
    :data:`HOLD_STATS` (the controllers-off branch of
    ``QuantConfig.range_update_every``)."""
    if bits >= 32 or not x.requires_grad:
        return x
    kw = dict(stochastic=stochastic, backend=backend,
              noise_shared_axis0=noise_shared_axis0,
              target_overflow_rate=target_overflow_rate, gate=bool(gate))
    return _Barrier.apply(x, sink, exp, (bits, key, kw))
