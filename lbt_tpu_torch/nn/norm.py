"""Quantized batch normalization as statistics + affine halves
(PyTorch port of the unfused ``BatchNorm`` in ``lbt_tpu/nn/norm.py``),
serving and training.

In training, ``Normalization`` takes the batch moments of its quantized
input: the biased ``mean(xq)`` and ``mean(xq^2) - mean^2``, from exact
integer sums of the codes (so the fused and unfused routes agree bit for
bit; ``lbt_tpu`` reduces in f32, which can differ in the last bit), EMA-
updates the running statistics with ``cfg.bn_momentum``, and normalizes
through :class:`_BatchNormalize`, whose backward is the BN input gradient
through the batch moments.  A ``BatchNorm`` that follows a conv runs the
conv and its own input quantize in one kernel (#4 / #5) through
:meth:`BatchNorm.forward_from`.
"""

from __future__ import annotations

import torch
from torch import nn

from lbt_tpu_torch.config import QuantConfig, carrier_dtype
from lbt_tpu_torch.dfxp.quantize import (dequantize, quantize_int,
                                         straight_through)
from lbt_tpu_torch.nn.core import Ctx, Layer, Sequential, site_init_exp
from lbt_tpu_torch.nn.layers import SITE_G, SITE_W, SITE_X, Conv2d, barrier
from lbt_tpu_torch.ops.qops import fusable, qconv2d_bn_input

# Rescale's site indices, as lbt_tpu's norm.py
SITE_GAMMA, SITE_BETA = 1, 2


def code_moments(codes: torch.Tensor) -> torch.Tensor:
    """int64 ``[2, C]``: per-channel sum of the codes and of their
    squares (the plain counterpart of what kernels #4 / #5 emit)."""
    c = codes.reshape(-1, codes.shape[-1]).to(torch.int64)
    return torch.stack([c.sum(0), (c * c).sum(0)])


def sqrt_f32(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of f32 ``t``, on any device.
    ``torch.sqrt`` of f32 on the CPU is not (one ulp off for ~0.7% of
    inputs); the card's, numpy's and XLA's are.  The float64 root rounded
    once to f32 is, so the CPU, the card and ``lbt_tpu`` agree."""
    return torch.sqrt(t.to(torch.float64)).to(torch.float32)


def batch_moments(moments: torch.Tensor, n: int, mult: torch.Tensor):
    """Biased batch ``(mean, var)`` (f32) of ``codes / mult`` from exact
    code sums: computed in float64, rounded once."""
    s = moments.to(torch.float64)
    m = mult.to(torch.float64)
    mean = s[0] / n / m
    var = s[1] / n / (m * m) - mean * mean
    return mean.to(torch.float32), var.to(torch.float32)


class _BatchNormalize(torch.autograd.Function):
    """``(xq - mean) / sqrt(var + eps)`` with ``mean``, ``var`` the batch
    moments of ``xq`` over every axis but the last.  The backward is the
    gradient through the moments as ``lbt_tpu``'s autodiff forms it:
    ``dxq = g/s + (dmean + 2 xq dm2) / N`` with ``s = sqrt(var + eps)``,
    ``dm2 = 0.5/s * sum(-g (xq - mean) s^-2)`` and ``dmean = -sum(g/s)
    - 2 mean dm2``."""

    @staticmethod
    def forward(ctx, xq, mean, var, eps):
        s = sqrt_f32(var + eps)
        num = xq - mean
        ctx.save_for_backward(xq, num, mean, s)
        return num / s

    @staticmethod
    def backward(ctx, g):
        xq, num, mean, s = ctx.saved_tensors
        axes = tuple(range(xq.dim() - 1))
        n = xq.numel() // xq.shape[-1]
        d_s = ((-g) * num * (1.0 / (s * s))).sum(axes)
        d_m2 = d_s * (0.5 / s)
        d_mean = -(g / s).sum(axes) - 2.0 * mean * d_m2
        dx = g / s + (d_mean / n) + (d_m2 / n) * (2.0 * xq)
        return dx, None, None, None


class Normalization(Layer):
    """BN statistics half: quantize the input at ``bits_a`` and normalize,
    ``(xq - mean) / sqrt(var + eps)`` — the same operations in the same
    order as lbt_tpu, not ``rsqrt``: batch moments in training, running
    statistics otherwise."""

    def __init__(self, name: str, cfg: QuantConfig, num_features: int,
                 eps: float = 1e-5):
        super().__init__(name, cfg)
        self.num_features = num_features
        self.eps = eps
        self._register_exps([
            ("x", cfg.bits_a, cfg.initial_exponent),
            ("grad", cfg.bits_g, site_init_exp(cfg, "grad")),
        ])
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def reset_parameters(self, generator):
        self.mean.zero_()
        self.var.fill_(1.0)
        self._reset_exps()

    def forward(self, x, ctx):
        cfg = self.cfg
        x = x.to(torch.float32)
        if cfg.bits_a >= 32:
            return self._normalize(x, None, None, ctx)
        key = ctx.layer_key(self.uid, SITE_X)
        out = quantize_int(x, cfg.bits_a, self.exp("x"), key,
                           stats=ctx.controls, **self._qkw(ctx))
        if ctx.controls:
            self._ctrl(ctx, "x", cfg.bits_a, x, out[2])
        xq = straight_through(x, dequantize(out[0], out[1]))
        moments = (code_moments(out[0]) if ctx.train or ctx.update
                   else None)
        return self._normalize(xq, moments, out[1], ctx)

    def forward_from_conv(self, conv: Conv2d, x, ctx: Ctx):
        """``conv`` then this layer, the conv and this layer's input
        quantize fused (kernel #4 or #5): the conv's controllers, sink and
        barrier are the conv's own."""
        cfg, ccfg = self.cfg, conv.cfg
        x = x.to(torch.float32)
        r = qconv2d_bn_input(
            x, conv.W, conv.exp("x"), conv.exp("w"), strides=conv.strides,
            padding=conv.padding, bits_x=ccfg.bits_a_conv,
            bits_w=ccfg.bits_w, bits_out=cfg.bits_a, exp_out=self.exp("x"),
            key_out=ctx.layer_key(self.uid, SITE_X), bits_g=ccfg.bits_g,
            exp_g=conv.exp("grad"), key_g=ctx.layer_key(conv.uid, SITE_G),
            sink=ctx.sink(conv), key_x=ctx.layer_key(conv.uid, SITE_X),
            key_w=ctx.layer_key(conv.uid, SITE_W),
            target_overflow_rate=ccfg.target_overflow_rate,
            gate=ctx.update_gate, stats=ctx.controls, **conv._qkw(ctx))
        if ctx.controls:
            conv._ctrl(ctx, "x", ccfg.bits_a_conv, x, r.minmax_x)
            conv._ctrl(ctx, "w", ccfg.bits_w, conv.W, r.minmax_w)
            # max(y * mult) == max(y) * mult: mult is a power of two
            self._ctrl(ctx, "x", cfg.bits_a, None, r.minmax * r.mult)
        return self._normalize(r.xq, r.moments, r.mult, ctx)

    def _normalize(self, xq, moments, mult, ctx: Ctx):
        cfg = self.cfg
        if ctx.train or ctx.update:
            if moments is not None:
                n = xq.numel() // xq.shape[-1]
                mean_b, var_b = batch_moments(moments, n, mult)
            else:  # bits_a = 32: float moments, differentiated by autograd
                axes = tuple(range(xq.dim() - 1))
                mean_b = xq.mean(axes)
                var_b = (xq * xq).mean(axes) - mean_b * mean_b
        if ctx.update:
            m = cfg.bn_momentum
            ctx.stage(self.mean, m * self.mean + (1 - m) * mean_b)
            ctx.stage(self.var, m * self.var + (1 - m) * var_b)
        if ctx.train and moments is not None:
            y = _BatchNormalize.apply(xq, mean_b, var_b, self.eps)
        elif ctx.train:
            y = (xq - mean_b) / sqrt_f32(var_b + self.eps)
        else:
            y = (xq - self.mean) / sqrt_f32(self.var + self.eps)
        return barrier(self, y, ctx).to(carrier_dtype(cfg))


class Rescale(Layer):
    """BN affine half: ``y = Xq * gamma_q + beta_q``, the input at
    ``bits_a`` and gamma, beta at ``bits_b``.  Weight decay applies to
    gamma, not beta."""

    def __init__(self, name: str, cfg: QuantConfig, num_features: int,
                 weight_decay: float = 0.0):
        super().__init__(name, cfg)
        self.num_features = num_features
        self.weight_decay = weight_decay
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features))
        init = cfg.initial_exponent
        self._register_exps([
            ("x", cfg.bits_a, init),
            ("gamma", cfg.bits_b, init),
            ("beta", cfg.bits_b, init),
            ("grad", cfg.bits_g, site_init_exp(cfg, "grad")),
        ])

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()
        self._reset_exps()

    def own_decay(self):
        return {"gamma": self.weight_decay, "beta": 0.0}

    def forward(self, x, ctx):
        cfg = self.cfg
        x = x.to(torch.float32)
        xq = self._quant(ctx, "x", x, cfg.bits_a, SITE_X)
        gq = self._quant(ctx, "gamma", self.gamma, cfg.bits_b, SITE_GAMMA)
        bq = self._quant(ctx, "beta", self.beta, cfg.bits_b, SITE_BETA)
        return barrier(self, xq * gq + bq, ctx).to(carrier_dtype(cfg))


class BatchNorm(Sequential):
    """Normalization + Rescale, as lbt_tpu's unfused ``BatchNorm``."""

    def __init__(self, name: str, cfg: QuantConfig, num_features: int,
                 eps: float = 1e-5, weight_decay: float = 0.0):
        super().__init__(name, [
            Normalization("norm", cfg, num_features, eps),
            Rescale("rescale", cfg, num_features, weight_decay),
        ])

    def fuses_with(self, layer: Layer) -> bool:
        """Whether ``layer`` then this BN can run as one fused kernel: a
        bias-free conv with a kernel for its shape, controllers at a zero
        target (they read min / max only)."""
        norm = self.layers[0]
        return (isinstance(layer, Conv2d) and not layer.use_bias
                and layer.cfg.bits_g <= 8
                and layer.cfg.target_overflow_rate == 0.0
                and norm.cfg.target_overflow_rate == 0.0
                and fusable(layer.ksize, norm.cfg.bits_a))

    def forward_from(self, conv: Conv2d, x, ctx: Ctx):
        norm, rescale = self.layers
        return rescale(norm.forward_from_conv(conv, x, ctx), ctx)
