"""Quantized leaf layers (PyTorch port of ``lbt_tpu/nn/layers.py``):
serving and training forwards.  Integer compute is delegated to
:mod:`lbt_tpu_torch.ops.qops`.

In training, each quantized site draws its stochastic noise from its own
key, ``fold_in(fold_in(step_key, uid), site)`` with ``lbt_tpu``'s site
indices (:data:`SITE_X` ...), measures its controller statistics in the
same K1 pass that quantizes it, and the layer's output passes the
cotangent barrier (``dfxp/barrier.py``) at the gradient site.  Dropout
draws its mask from the site-4 key (``jax.random.bernoulli``'s stream);
``GradientBuffer`` quantizes the cotangent plus an error-feedback buffer
at the site-3 key.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lbt_tpu_torch.config import QuantConfig, carrier_dtype
from lbt_tpu_torch.dfxp.barrier import grad_quant_barrier, quantize_cotangent
from lbt_tpu_torch.dfxp.quantize import dequantize
from lbt_tpu_torch.nn.core import Ctx, Layer, site_init_exp
from lbt_tpu_torch.ops.kernels.quant import (rbg_uniform_flat,
                                             threefry_uniform_flat)
from lbt_tpu_torch.ops.qops import qconv2d, qmatmul

# PRNG site indices (folded into the layer key), as lbt_tpu's
SITE_X, SITE_W, SITE_B, SITE_G, SITE_DROP = range(5)


def _uniform_(t: torch.Tensor, limit: float, generator) -> None:
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_(u * (2 * limit) - limit)


def barrier(layer: Layer, y: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The layer's cotangent barrier at its gradient site."""
    cfg = layer.cfg
    if cfg.bits_g >= 32:
        return y
    return grad_quant_barrier(
        y, cfg.bits_g, layer.exp("grad"), ctx.sink(layer),
        ctx.layer_key(layer.uid, SITE_G),
        target_overflow_rate=cfg.target_overflow_rate,
        gate=ctx.update_gate, **layer._qkw(ctx))


class _QuantLeaf(Layer):
    """Shared shape of Dense and Conv2d: weight ``W``, optional bias ``b``,
    exponent sites x, w, grad (and b).  ``W`` decays by ``weight_decay``,
    ``b`` does not.  Under tensor parallelism ``shard``
    (``parallel.mesh.Shard``, set by ``parallel.mesh.shard_model``) says
    which output columns this rank's ``W`` holds: the layer contracts the
    whole input with them and joins the model group's outputs along the
    channel dim (``ops.qops``), so what follows the contraction (bias,
    barrier, carrier) runs on the whole output."""

    def __init__(self, name, cfg, wshape, bits_x, use_bias, weight_decay):
        super().__init__(name, cfg)
        self.use_bias = use_bias
        self.weight_decay = weight_decay
        self.shard = None
        self.W = nn.Parameter(torch.zeros(wshape))
        sites = [("x", bits_x), ("w", cfg.bits_w), ("grad", cfg.bits_g)]
        if use_bias:
            self.b = nn.Parameter(torch.zeros(wshape[-1]))
            sites.append(("b", cfg.bits_b))
        self._register_exps(
            (s, bits, site_init_exp(cfg, s)) for s, bits in sites)

    def _fan_limit(self) -> float:
        raise NotImplementedError

    def reset_parameters(self, generator):
        _uniform_(self.W, self._fan_limit(), generator)
        if self.use_bias:
            with torch.no_grad():
                self.b.zero_()
        self._reset_exps()

    def own_decay(self):
        d = {"W": self.weight_decay}
        if self.use_bias:
            d["b"] = 0.0
        return d

    def _operands(self, ctx: Ctx, bits_x: int) -> dict:
        """Keyword arguments of the quantized contraction: exponents,
        widths, site keys, rounding and whether to return statistics."""
        cfg = self.cfg
        return dict(bits_x=bits_x, bits_w=cfg.bits_w,
                    exp_g=self.exp("grad"), bits_g=cfg.bits_g,
                    engine=cfg.engine,
                    key_x=ctx.layer_key(self.uid, SITE_X),
                    key_w=ctx.layer_key(self.uid, SITE_W),
                    stats=ctx.controls, row0=ctx.row0, shard=self.shard,
                    **self._qkw(ctx))

    def _finish(self, x, out, ctx: Ctx, bits_x: int) -> torch.Tensor:
        """Controllers of x and W, the bias, the barrier, the carrier."""
        if ctx.controls:
            y, mm_x, mm_w = out
            self._ctrl(ctx, "x", bits_x, x, mm_x)
            self._ctrl(ctx, "w", self.cfg.bits_w, self.W, mm_w,
                       shard=self.shard)
        else:
            y = out
        if self.use_bias:
            y = y + self._quant(ctx, "b", self.b, self.cfg.bits_b, SITE_B)
        return barrier(self, y, ctx).to(carrier_dtype(self.cfg))


class Dense(_QuantLeaf):
    """Quantized fully-connected layer, ``y = Xq @ Wq + bq``, X at
    ``bits_a`` (dense activations get no extra bit) and W at ``bits_w``;
    ``W`` is ``[in, out]``."""

    def __init__(self, name: str, cfg: QuantConfig, in_units: int,
                 units: int, use_bias: bool = True,
                 weight_decay: float = 0.0):
        super().__init__(name, cfg, (in_units, units), cfg.bits_a, use_bias,
                         weight_decay)
        self.in_units = in_units
        self.units = units

    def _fan_limit(self):
        return (6.0 / (self.in_units + self.units)) ** 0.5

    def forward(self, x, ctx):
        x = x.to(torch.float32)
        bits_x = self.cfg.bits_a
        out = qmatmul(x, self.W, self.exp("x"), self.exp("w"),
                      **self._operands(ctx, bits_x))
        return self._finish(x, out, ctx, bits_x)


class Conv2d(_QuantLeaf):
    """Quantized 2-d convolution, NHWC activations and an HWIO ``W``.
    Activations are quantized at ``bits_a + conv_act_extra``, weights at
    ``bits_w``."""

    def __init__(self, name: str, cfg: QuantConfig,
                 ksize: Tuple[int, int, int, int],
                 strides: Tuple[int, int] = (1, 1), padding="SAME",
                 use_bias: bool = True, weight_decay: float = 0.0):
        super().__init__(name, cfg, tuple(ksize), cfg.bits_a_conv, use_bias,
                         weight_decay)
        self.ksize = tuple(ksize)  # (kh, kw, Cin, Cout)
        self.strides = tuple(strides)
        self.padding = padding

    def _fan_limit(self):
        kh, kw, cin, _ = self.ksize
        return (3.0 / (kh * kw * cin)) ** 0.5

    def forward(self, x, ctx):
        x = x.to(torch.float32)
        bits_x = self.cfg.bits_a_conv
        out = qconv2d(x, self.W, self.exp("x"), self.exp("w"),
                      strides=self.strides, padding=self.padding,
                      **self._operands(ctx, bits_x))
        return self._finish(x, out, ctx, bits_x)


class ReLU(Layer):
    """``where(x > 0, x, 0)``: the tie rule of lbt_tpu's ReLU (zero
    gradient at exactly 0)."""

    def forward(self, x, ctx):
        return torch.where(x > 0, x, 0.0)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-style SAME padding ``(lo, hi)`` of one dim: the extra on hi."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _MaxPool(torch.autograd.Function):
    """Max over NHWC windows of ``x`` padded with ``-inf``.  The backward
    sends each window's cotangent to its first maximum in row-major window
    order, and an input position collects the windows that chose it in
    row-major order of the windows, as ``lbt_tpu``'s ``reduce_window`` max
    (select-and-scatter) does; sums of overlapping windows run in
    ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, ksize, strides, pads):
        (kh, kw), (sh, sw), ((pt, pb), (pl, pr)) = ksize, strides, pads
        xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb),
                                     value=float("-inf"))
        ho = (xp.shape[1] - kh) // sh + 1
        wo = (xp.shape[2] - kw) // sw + 1

        def tap(t):
            i, j = divmod(t, kw)
            return xp[:, i:i + sh * (ho - 1) + 1:sh,
                      j:j + sw * (wo - 1) + 1:sw]

        y = tap(0).clone()
        arg = torch.zeros(y.shape, dtype=torch.uint8, device=x.device)
        for t in range(1, kh * kw):
            v = tap(t)
            take = v > y   # strict: a tie keeps the earlier tap
            y = torch.where(take, v, y)
            arg.masked_fill_(take, t)
        ctx.save_for_backward(arg)
        ctx.geom = (tuple(x.shape), ksize, strides, pads, tuple(xp.shape))
        return y

    @staticmethod
    def backward(ctx, g):
        (arg,) = ctx.saved_tensors
        shape, (kh, kw), (sh, sw), ((pt, _), (pl, _)), pshape = ctx.geom
        ho, wo = g.shape[1:3]
        dxp = g.new_zeros(pshape)
        # taps from the last to the first: the windows an input position
        # meets arrive in row-major order of the windows
        for t in reversed(range(kh * kw)):
            i, j = divmod(t, kw)
            dxp[:, i:i + sh * (ho - 1) + 1:sh,
                j:j + sw * (wo - 1) + 1:sw] += torch.where(arg == t, g, 0.0)
        return (dxp[:, pt:pt + shape[1], pl:pl + shape[2]], None, None,
                None)


class MaxPool(Layer):
    """Max pooling over NHWC windows, VALID or SAME (padded with -inf,
    the extra row and column at the end, as TF's SAME)."""

    def __init__(self, name: str = "", *, ksize: Tuple[int, int],
                 strides: Tuple[int, int], padding: str = "VALID"):
        super().__init__(name)
        self.ksize = tuple(ksize)
        self.strides = tuple(strides)
        self.padding = padding.upper()
        if self.padding not in ("VALID", "SAME"):
            raise ValueError(f"bad padding {padding!r}")

    def forward(self, x, ctx):
        if self.padding == "SAME":
            pads = tuple(_same_pads(n, k, s) for n, k, s in
                         zip(x.shape[1:3], self.ksize, self.strides))
        else:
            pads = ((0, 0), (0, 0))
        return _MaxPool.apply(x, self.ksize, self.strides, pads)


class AvgPool(Layer):
    """Average pooling over NHWC windows: window sums at f32 divided by
    the count of real (unpadded) positions in the window, as
    ``tf.nn.avg_pool``; SAME pads with zeros, the extra at the end, and
    its divisor is the window sum of ones."""

    def __init__(self, name: str = "", *, ksize: Tuple[int, int],
                 strides: Tuple[int, int], padding: str = "VALID"):
        super().__init__(name)
        self.ksize = tuple(ksize)
        self.strides = tuple(strides)
        self.padding = padding.upper()
        if self.padding not in ("VALID", "SAME"):
            raise ValueError(f"bad padding {padding!r}")

    def _window_sums(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.ksize, self.strides
        return x.unfold(1, kh, sh).unfold(2, kw, sw).sum(dim=(-2, -1))

    def forward(self, x, ctx):
        xf = x.to(torch.float32)
        if self.padding == "VALID":
            total = self._window_sums(xf)
            return (total / float(self.ksize[0] * self.ksize[1])).to(x.dtype)
        (pt, pb), (pl, pr) = (_same_pads(n, k, s) for n, k, s in
                              zip(x.shape[1:3], self.ksize, self.strides))
        pad = (0, 0, pl, pr, pt, pb)
        count = self._window_sums(F.pad(xf.new_ones((1,) + x.shape[1:3]
                                                    + (1,)), pad))
        return (self._window_sums(F.pad(xf, pad)) / count).to(x.dtype)


class Dropout(Layer):
    """Inverted dropout, ``keep`` the keep probability (the CLI's
    ``--dropout``); active only in training with ``keep < 1``.  The mask is
    ``jax.random.bernoulli(key, keep, shape)`` of the site-4 key bit for
    bit: the key's uniforms of the flat index (threefry, or XLA's Philox
    stream under an unsafe_rbg key) below ``keep`` in f32.
    Kept elements become ``x / keep`` in ``x``'s dtype, ``keep`` rounded
    to that dtype first (JAX's weak-typed scalar)."""

    def __init__(self, name: str = "", *, keep: float = 0.5):
        super().__init__(name)
        self.keep = keep

    def forward(self, x, ctx):
        if not ctx.train or self.keep >= 1.0:
            return x
        key = ctx.layer_key(self.uid, SITE_DROP)
        if key is None:
            raise ValueError("training dropout needs a PRNG key")
        # rows row0.. of a global batch draw that batch's mask there
        offset = ctx.row0 * math.prod(x.shape[1:])
        if len(key) == 4:
            u = rbg_uniform_flat(key, x.numel(), device=x.device,
                                 offset=offset)
        else:
            u = threefry_uniform_flat(*key, x.numel(), device=x.device,
                                      offset=offset)
        # 0-d CPU tensors: scalars to an op on any device, no copy
        mask = u.view(x.shape) < torch.tensor(self.keep, dtype=torch.float32)
        keep = torch.tensor(self.keep, dtype=torch.float32).to(x.dtype)
        return torch.where(mask, x / keep, 0.0)


class Flatten(Layer):
    """Reshape to ``[N, dim]`` (NHWC order)."""

    def forward(self, x, ctx):
        return x.reshape(x.shape[0], -1)


class SpaceToDepth(Layer):
    """NHWC block rearrange, ``[B, H, W, C] -> [B, H/b, W/b, b*b*C]``,
    output channels in ``(ph, pw, c)`` order, phase-major, as
    ``lbt_tpu``'s.  Stateless and exact; autograd differentiates the
    reshape and permute.  The s2d ImageNet stem (``QuantConfig.stem_s2d``)
    runs a 4x4/s1 conv over its output in place of the 7x7/s2 conv."""

    def __init__(self, name: str = "", *, block: int = 2):
        super().__init__(name)
        self.block = int(block)

    def forward(self, x, ctx):
        b = self.block
        n, h, w, c = x.shape
        if h % b or w % b:
            raise ValueError(f"{tuple(x.shape)} is not divisible by {b}")
        y = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, h // b, w // b, b * b * c)


class _GradBuf(torch.autograd.Function):
    """Identity forward.  Backward: ``total = g + buffer``, quantized at
    the layer's gradient site (``bits_g``, its exponent, the site-3 key),
    with the overflow statistics of ``total`` into the sink (the hold
    sentinel when the controllers are gated off); ``total - gq`` is
    staged as the new buffer and ``gq`` passes on in ``g``'s dtype."""

    @staticmethod
    def forward(ctx, x, sink, layer, tctx):
        ctx.layer, ctx.tctx, ctx.has_sink = layer, tctx, sink is not None
        # no key (a keyless training call) draws from key data (0, 0), as
        # lbt_tpu's zero key data
        ctx.key = tctx.layer_key(layer.uid, SITE_G) or (0, 0)
        ctx.gate = tctx.update_gate
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        layer, cfg = ctx.layer, ctx.layer.cfg
        total = g + layer.buffer
        codes, mult, stats = quantize_cotangent(
            total, cfg.bits_g, layer.exp("grad"), ctx.key,
            stochastic=cfg.stochastic, backend=cfg.quant_backend,
            noise_shared_axis0=cfg.noise_shared_axis0,
            target_overflow_rate=cfg.target_overflow_rate, gate=ctx.gate)
        gq = dequantize(codes, mult)
        ctx.tctx.stage(layer.buffer, total - gq, mean=True)
        return gq.to(g.dtype), (stats if ctx.has_sink else None), None, None


class GradientBuffer(Layer):
    """Error-feedback gradient quantizer (``lbt_tpu``'s ``GradientBuffer``,
    the reference's ``GradientBuffer_q``): the identity forward; the
    backward adds the persistent residual ``buffer`` (a module buffer of
    the fixed activation ``shape``) to the cotangent, quantizes the sum at
    ``bits_g`` and keeps the quantization error as the next buffer,
    staged on the :class:`Ctx` and committed after the backward pass.  Its
    gradient-site exponent steps from its sink as a barrier's does.
    Outside training it is the identity and the buffer is untouched."""

    def __init__(self, name: str, cfg: QuantConfig,
                 shape: Tuple[int, ...]):
        super().__init__(name, cfg)
        self.shape = tuple(shape)
        if cfg.bits_g < 32:
            self._register_exps([("grad", cfg.bits_g,
                                  site_init_exp(cfg, "grad"))])
            self.register_buffer("buffer", torch.zeros(self.shape))

    def reset_parameters(self, generator):
        if self.cfg.bits_g < 32:
            self.buffer.zero_()
        self._reset_exps()

    def forward(self, x, ctx):
        if self.cfg.bits_g >= 32 or not ctx.train:
            return x
        if tuple(x.shape) != self.shape:
            raise ValueError(f"GradientBuffer {self.name!r} expects shape "
                             f"{self.shape}, got {tuple(x.shape)}")
        return _GradBuf.apply(x, ctx.sink(self), self, ctx)
