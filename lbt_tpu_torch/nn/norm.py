"""Quantized batch normalization (PyTorch port of ``lbt_tpu/nn/norm.py``),
serving and training: the statistics + affine halves ``Normalization``
and ``Rescale``, or with ``cfg.fused_bn`` the single-pass
``FusedBatchNorm`` (one input quantize, one cotangent barrier).

In training, ``Normalization`` and ``FusedBatchNorm`` take the batch
moments of their quantized input: the biased ``mean(xq)`` and ``mean(xq^2)
- mean^2``, from exact integer sums of the codes (so the fused and unfused
routes agree bit for bit; ``lbt_tpu`` reduces in f32, which can differ in
the last bit), EMA-update the running statistics with ``cfg.bn_momentum``,
and normalize through an ``autograd.Function`` whose backward is the
gradient through the batch moments.  A ``BatchNorm`` that follows a conv
runs the conv and its own input quantize in one kernel (#4 / #5) through
:meth:`BatchNorm.forward_from`.

Data parallel (``Ctx.dist``), BN is sync-BN over the global batch, as
``lbt_tpu``'s ``pmean`` of the moments: the exact integer code sums are
summed over the ranks (``n`` the global count, every rank holding as many
rows), so every rank normalizes with the same moments; the backward sums
the per-channel cotangents of the moments over the ranks and divides by
the global ``n`` (the transpose of ``pmean``), so a data-parallel step is
the global batch's step.  The EMA takes the synced moments.

``cfg.remat_bn`` and ``cfg.bn_residual_q16`` (``lbt_tpu``'s two BN
memory options, there ``jax.checkpoint`` around each BN layer) keep the
same numbers with less saved for the backward: in training every BN layer
saves its input's integer codes (int8, int16 past 8 bits) and per-channel
tensors, and rebuilds ``xq`` from the codes in the backward.  Nothing runs
twice: the forward's side effects (the controllers, the EMA, the sinks,
sync-BN's collective, a sharded conv's join) happen once.
``FusedBatchNorm`` and the fused conv route save codes with or without
the flags.  A 32-bit input site has no codes and keeps autograd.
``bn_residual_q16`` also rounds the cotangent of the BN's quantized
input to bf16 (``lbt_tpu``'s ``_tag_xq``: the transpose of its bf16
storage cast) where ``bits_a <= 9``, whatever ``remat_bn`` says; under
bf16 carriers that rounding is the carrier's own, so nothing changes.
"""

from __future__ import annotations

import math

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
    """The correctly rounded f32 square root of f32 ``t``, on any device,
    as the card's, numpy's and XLA's are.  ``torch.sqrt`` of f32 on the
    CPU is not (one ulp off for ~0.7% of inputs), and its float64 root,
    vectorized, is not correctly rounded either: rounded to f32 it lands
    one ulp off now and then, in no fixed place.  So on the CPU the f32
    rounding of the float64 root moves by one ulp where the exact square
    of a rounding midpoint says it must (every step exact in float64),
    and the gradient stays the root's; the card's float64 root is
    correctly rounded, and its f32 rounding is the answer."""
    x = t.to(torch.float64)
    r = torch.sqrt(x).to(torch.float32)
    if t.device.type != "cpu":
        return r
    with torch.no_grad():
        up = torch.nextafter(r, torch.full_like(r, math.inf))
        down = torch.nextafter(r, torch.zeros_like(r))
        rd = r.to(torch.float64)
        hi = (rd + up.to(torch.float64)) * 0.5
        lo = (rd + down.to(torch.float64)) * 0.5
        # one ulp up or down (adjacent floats differ by an exact f32)
        step = torch.where(x > hi * hi, up - r,
                           torch.where(x < lo * lo, down - r, 0.0))
        step = torch.where(torch.isfinite(r), step, 0.0)
    return r + step


def _sync_moments(ctx: Ctx, moments: torch.Tensor, n: int):
    """``(moments, n)`` over the global batch under ``ctx.dist`` (code
    sums summed over the ranks, exact), else as given."""
    if ctx.dist is None:
        return moments, n
    return ctx.dist.all_reduce(moments), n * ctx.dist.world


def _sync_cotangents(dist, n: int, *sums):
    """The moments' per-channel cotangents summed over the ranks, each
    divided by the global count, as JAX transposes ``pmean`` then the
    local mean; ``(sums / n)`` on one device."""
    if dist is None:
        return [s / n for s in sums]
    total = dist.all_reduce(torch.stack(sums)) / dist.world
    return [t / n for t in total]


def batch_moments(moments: torch.Tensor, n: int, mult: torch.Tensor):
    """Biased batch ``(mean, var)`` (f32) of ``codes / mult`` from exact
    code sums: computed in float64, rounded once."""
    s = moments.to(torch.float64)
    m = mult.to(torch.float64)
    mean = s[0] / n / m
    var = s[1] / n / (m * m) - mean * mean
    return mean.to(torch.float32), var.to(torch.float32)


def _saves_codes(cfg: QuantConfig) -> bool:
    """Whether a BN layer under ``cfg`` saves its input's codes for the
    backward in place of f32 activations."""
    return cfg.remat_bn or cfg.bn_residual_q16


class _RoundCotangent(torch.autograd.Function):
    """Identity forward; the backward rounds the cotangent to bf16 (round
    to nearest even) and back to f32."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _q16(cfg: QuantConfig, xq: torch.Tensor,
         carrier: torch.dtype) -> torch.Tensor:
    """``xq`` (a BN layer's quantized input, which reached the layer in
    ``carrier``) with ``bn_residual_q16``'s bf16 rounding of its
    cotangent, where ``bits_a <= 9``.  A bf16 input's cotangent is
    rounded to bf16 at the layer's entry (the cast's backward), so there
    the rounding is left to it."""
    if (cfg.bn_residual_q16 and cfg.bits_a <= 9 and xq.requires_grad
            and carrier != torch.bfloat16):
        return _RoundCotangent.apply(xq)
    return xq


class _BatchNormalize(torch.autograd.Function):
    """``(xq - mean) / sqrt(var + eps)`` with ``mean``, ``var`` the batch
    moments of ``xq`` over every axis but the last.  The backward is the
    gradient through the moments as ``lbt_tpu``'s autodiff forms it:
    ``dxq = g/s + (dmean + 2 xq dm2) / N`` with ``s = sqrt(var + eps)``,
    ``dm2 = 0.5/s * sum(-g (xq - mean) s^-2)`` and ``dmean = -sum(g/s)
    - 2 mean dm2``.  Given ``codes`` (``xq = codes / mult``) it saves them
    in place of ``xq`` and ``xq - mean`` and rebuilds both."""

    @staticmethod
    def forward(ctx, xq, mean, var, eps, dist, codes=None, mult=None):
        s = sqrt_f32(var + eps)
        num = xq - mean
        if codes is None:
            ctx.save_for_backward(xq, num, mean, s)
        else:
            ctx.save_for_backward(codes, mult, mean, s)
        ctx.dist, ctx.rebuild = dist, codes is not None
        return num / s

    @staticmethod
    def backward(ctx, g):
        if ctx.rebuild:
            codes, mult, mean, s = ctx.saved_tensors
            xq = dequantize(codes, mult)
            num = xq - mean
        else:
            xq, num, mean, s = ctx.saved_tensors
        axes = tuple(range(xq.dim() - 1))
        n = xq.numel() // xq.shape[-1]
        d_s = ((-g) * num * (1.0 / (s * s))).sum(axes)
        d_m2 = d_s * (0.5 / s)
        d_mean = -(g / s).sum(axes) - 2.0 * mean * d_m2
        d_mean, d_m2 = _sync_cotangents(ctx.dist, n, d_mean, d_m2)
        dx = g / s + d_mean + d_m2 * (2.0 * xq)
        return dx, None, None, None, None, None, None


def _quantize_input(layer: Layer, x, ctx: Ctx):
    """``(xq, codes, mult)`` of a BN layer's input ``x`` (in its carrier)
    at ``bits_a``, ``xq`` f32 (it carries the STE gradient to ``x``),
    staging the site's controller step."""
    cfg, carrier = layer.cfg, x.dtype
    x = x.to(torch.float32)
    out = quantize_int(x, cfg.bits_a, layer.exp("x"),
                       ctx.layer_key(layer.uid, SITE_X),
                       stats=ctx.controls, row0=ctx.row0, **layer._qkw(ctx))
    if ctx.controls:
        layer._ctrl(ctx, "x", cfg.bits_a, x, out[2])
    xq = _q16(cfg, straight_through(x, dequantize(out[0], out[1])),
              carrier)
    return xq, out[0], out[1]


def _conv_input(layer: Layer, conv: Conv2d, x, ctx: Ctx):
    """``conv`` and ``layer``'s input quantize fused (kernel #4 or #5):
    :class:`~lbt_tpu_torch.ops.qops.BNInput`, with the conv's and the
    input site's controller steps staged.  The conv's sink and barrier
    are the conv's own; its output rounds to the conv's carrier dtype
    before the quantize, as ``Conv2d`` casts it.  A sharded conv's BN
    input comes back whole (its codes and moments joined over the model
    group), so the BN that follows runs as on one rank."""
    cfg, ccfg = layer.cfg, conv.cfg
    x = x.to(torch.float32)
    r = qconv2d_bn_input(
        x, conv.W, conv.exp("x"), conv.exp("w"), strides=conv.strides,
        padding=conv.padding, bits_x=ccfg.bits_a_conv,
        bits_w=ccfg.bits_w, bits_out=cfg.bits_a, exp_out=layer.exp("x"),
        key_out=ctx.layer_key(layer.uid, SITE_X), bits_g=ccfg.bits_g,
        exp_g=conv.exp("grad"), key_g=ctx.layer_key(conv.uid, SITE_G),
        sink=ctx.sink(conv), key_x=ctx.layer_key(conv.uid, SITE_X),
        key_w=ctx.layer_key(conv.uid, SITE_W),
        target_overflow_rate=ccfg.target_overflow_rate,
        gate=ctx.update_gate, stats=ctx.controls,
        carrier=carrier_dtype(ccfg), row0=ctx.row0, shard=conv.shard,
        **conv._qkw(ctx))
    if ctx.controls:
        conv._ctrl(ctx, "x", ccfg.bits_a_conv, x, r.minmax_x)
        conv._ctrl(ctx, "w", ccfg.bits_w, conv.W, r.minmax_w,
                   shard=conv.shard)
        # max(y * mult) == max(y) * mult: mult is a power of two; a
        # sharded conv's is its slice's, reduced over the model group
        layer._ctrl(ctx, "x", cfg.bits_a, None, r.minmax * r.mult,
                    shard=conv.shard)
    return r._replace(xq=_q16(cfg, r.xq, carrier_dtype(ccfg)))


def _stage_ema(layer: Layer, ctx: Ctx, mean_b, var_b) -> None:
    m = layer.cfg.bn_momentum
    ctx.stage(layer.mean, m * layer.mean + (1 - m) * mean_b)
    ctx.stage(layer.var, m * layer.var + (1 - m) * var_b)


class _GlobalMean(torch.autograd.Function):
    """``pmean`` of per-rank ``[mean, m2]``: the sum over the ranks over
    N; its backward is the transpose, the cotangent summed over the ranks
    over N."""

    @staticmethod
    def forward(ctx, t, dist):
        ctx.dist = dist
        return dist.mean(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.dist.mean(g), None


def _float_moments(xq, dist=None):
    """Biased batch ``(mean, var)`` of float ``xq`` (a 32-bit input site),
    differentiated by autograd; over the global batch under ``dist``."""
    axes = tuple(range(xq.dim() - 1))
    mean = xq.mean(axes)
    m2 = (xq * xq).mean(axes)
    if dist is not None:
        mean, m2 = _GlobalMean.apply(torch.stack([mean, m2]), dist)
    return mean, m2 - mean * mean


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
        if self.cfg.bits_a >= 32:
            return self._normalize(x.to(torch.float32), None, None, ctx)
        xq, codes, mult = _quantize_input(self, x, ctx)
        moments = (code_moments(codes) if ctx.train or ctx.update
                   else None)
        return self._normalize(xq, moments, mult, ctx, codes)

    def forward_from_conv(self, conv: Conv2d, x, ctx: Ctx):
        """``conv`` then this layer, the conv and this layer's input
        quantize fused (kernel #4 or #5)."""
        r = _conv_input(self, conv, x, ctx)
        return self._normalize(r.xq, r.moments, r.mult, ctx, r.codes)

    def _normalize(self, xq, moments, mult, ctx: Ctx, codes=None):
        cfg = self.cfg
        if ctx.train or ctx.update:
            if moments is not None:
                mean_b, var_b = batch_moments(*_sync_moments(
                    ctx, moments, xq.numel() // xq.shape[-1]), mult)
            else:  # bits_a = 32: float moments, differentiated by autograd
                mean_b, var_b = _float_moments(xq, ctx.dist)
        if ctx.update:
            _stage_ema(self, ctx, mean_b, var_b)
        if ctx.train and moments is not None:
            y = _BatchNormalize.apply(
                xq, mean_b, var_b, self.eps, ctx.dist,
                *((codes, mult) if _saves_codes(cfg) else ()))
        elif ctx.train:
            y = (xq - mean_b) / sqrt_f32(var_b + self.eps)
        else:
            y = (xq - self.mean) / sqrt_f32(self.var + self.eps)
        return barrier(self, y, ctx).to(carrier_dtype(cfg))


class _Rescale(torch.autograd.Function):
    """``xq * gq + bq``, saving ``xq``'s codes and ``gq`` where autograd
    would save ``xq``; the backward is autograd's, ``xq`` rebuilt from the
    codes."""

    @staticmethod
    def forward(ctx, xq, gq, bq, codes, mult):
        ctx.save_for_backward(codes, mult, gq)
        return xq * gq + bq

    @staticmethod
    def backward(ctx, g):
        codes, mult, gq = ctx.saved_tensors
        axes = tuple(range(g.dim() - 1))
        return (g * gq, (g * dequantize(codes, mult)).sum(axes), g.sum(axes),
                None, None)


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
        if cfg.bits_a < 32:
            xq, codes, mult = _quantize_input(self, x, ctx)
        else:
            xq, codes = x.to(torch.float32), None
        gq = self._quant(ctx, "gamma", self.gamma, cfg.bits_b, SITE_GAMMA)
        bq = self._quant(ctx, "beta", self.beta, cfg.bits_b, SITE_BETA)
        if ctx.train and codes is not None and _saves_codes(cfg):
            y = _Rescale.apply(xq, gq, bq, codes, mult)
        else:
            y = xq * gq + bq
        return barrier(self, y, ctx).to(carrier_dtype(cfg))


class _FusedNormalize(torch.autograd.Function):
    """``(xq - mean) * (gq / sqrt(var + eps)) + bq``, ``lbt_tpu``'s
    operation order, with ``mean``, ``var`` the batch moments of ``xq =
    codes / mult`` over every axis but the last.  The backward is the
    gradient through the moments and to ``gq`` and ``bq`` as ``lbt_tpu``'s
    autodiff forms it (``r = gq / s``, ``s = sqrt(var + eps)``):
    ``dbq = sum(g)``, ``dr = sum(g (xq - mean))``, ``dgq = dr / s``,
    ``dvar = -dr gq s^-2 * 0.5/s``, ``dmean = -sum(g r) - 2 mean dvar``
    and ``dxq = g r + dmean / N + (dvar / N) 2 xq``.  It saves the int8
    codes, not the f32 ``xq``, and rebuilds ``xq`` from them."""

    @staticmethod
    def forward(ctx, xq, gq, bq, mean, var, codes, mult, eps, dist):
        s = sqrt_f32(var + eps)
        ctx.save_for_backward(codes, mult, gq, mean, s)
        ctx.dist = dist
        return (xq - mean) * (gq / s) + bq

    @staticmethod
    def backward(ctx, g):
        codes, mult, gq, mean, s = ctx.saved_tensors
        xq = dequantize(codes, mult)
        axes = tuple(range(xq.dim() - 1))
        n = xq.numel() // xq.shape[-1]
        gr = g * (gq / s)
        d_r = (g * (xq - mean)).sum(axes)
        d_var = ((-d_r) * gq * (1.0 / (s * s))) * (0.5 / s)
        d_mean = -gr.sum(axes) - 2.0 * mean * d_var
        d_mean_n, d_var_n = _sync_cotangents(ctx.dist, n, d_mean, d_var)
        dx = gr + d_mean_n + d_var_n * (2.0 * xq)
        return dx, d_r / s, g.sum(axes), None, None, None, None, None, None


class FusedBatchNorm(Layer):
    """Single-pass BN (``lbt_tpu``'s ``FusedBatchNorm``, ``cfg.fused_bn``):
    quantize the input once at ``bits_a``, normalize with batch (training)
    or running moments, apply the affine with gamma and beta quantized at
    ``bits_b``, ``(xq - mean) * (gq / sqrt(var + eps)) + bq``, and put one
    cotangent barrier at the output.  Weight decay applies to gamma, not
    beta."""

    def __init__(self, name: str, cfg: QuantConfig, num_features: int,
                 eps: float = 1e-5, weight_decay: float = 0.0):
        super().__init__(name, cfg)
        self.num_features = num_features
        self.eps = eps
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
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)
        self._reset_exps()

    def own_decay(self):
        return {"gamma": self.weight_decay, "beta": 0.0}

    def forward(self, x, ctx):
        if self.cfg.bits_a >= 32:
            return self._normalize(x.to(torch.float32), None, None, None,
                                   ctx)
        xq, codes, mult = _quantize_input(self, x, ctx)
        moments = (code_moments(codes) if ctx.train or ctx.update
                   else None)
        return self._normalize(xq, codes, moments, mult, ctx)

    def forward_from_conv(self, conv: Conv2d, x, ctx: Ctx):
        """``conv`` then this layer, the conv and this layer's input
        quantize fused (kernel #4 or #5)."""
        r = _conv_input(self, conv, x, ctx)
        return self._normalize(r.xq, r.codes, r.moments, r.mult, ctx)

    def _normalize(self, xq, codes, moments, mult, ctx: Ctx):
        cfg = self.cfg
        gq = self._quant(ctx, "gamma", self.gamma, cfg.bits_b, SITE_GAMMA)
        bq = self._quant(ctx, "beta", self.beta, cfg.bits_b, SITE_BETA)
        if ctx.train or ctx.update:
            if moments is not None:
                mean_b, var_b = batch_moments(*_sync_moments(
                    ctx, moments, xq.numel() // xq.shape[-1]), mult)
            else:
                mean_b, var_b = _float_moments(xq, ctx.dist)
        if ctx.update:
            _stage_ema(self, ctx, mean_b, var_b)
        if ctx.train and moments is not None:
            y = _FusedNormalize.apply(xq, gq, bq, mean_b, var_b, codes,
                                      mult, self.eps, ctx.dist)
        else:
            mean, var = ((mean_b, var_b) if ctx.train
                         else (self.mean, self.var))
            y = (xq - mean) * (gq / sqrt_f32(var + self.eps)) + bq
        return barrier(self, y, ctx).to(carrier_dtype(cfg))


class BatchNorm(Sequential):
    """Normalization + Rescale, as lbt_tpu's unfused ``BatchNorm``; with
    ``cfg.fused_bn`` its one child is ``FusedBatchNorm("fused")``, as in
    ``lbt_tpu``."""

    def __init__(self, name: str, cfg: QuantConfig, num_features: int,
                 eps: float = 1e-5, weight_decay: float = 0.0):
        if cfg.fused_bn:
            layers = [FusedBatchNorm("fused", cfg, num_features, eps,
                                     weight_decay)]
        else:
            layers = [Normalization("norm", cfg, num_features, eps),
                      Rescale("rescale", cfg, num_features, weight_decay)]
        super().__init__(name, layers)

    def fuses_with(self, layer: Layer) -> bool:
        """Whether ``layer`` then this BN can run as one fused kernel: a
        bias-free conv on the integer route (``int8`` / ``pallas``) with a
        kernel for its shape and widths, controllers at a zero target
        (they read min / max only).  Under ``sim`` / ``sim_bf16`` the conv
        runs on its own and K1 quantizes the BN input."""
        norm, ccfg = self.layers[0], layer.cfg
        return (isinstance(layer, Conv2d) and not layer.use_bias
                and ccfg.target_overflow_rate == 0.0
                and norm.cfg.target_overflow_rate == 0.0
                and fusable(layer.ksize, norm.cfg.bits_a, ccfg.engine,
                            ccfg.bits_a_conv, ccfg.bits_w, ccfg.bits_g))

    def forward_from(self, conv: Conv2d, x, ctx: Ctx):
        y = self.layers[0].forward_from_conv(conv, x, ctx)
        return y if len(self.layers) == 1 else self.layers[1](y, ctx)
