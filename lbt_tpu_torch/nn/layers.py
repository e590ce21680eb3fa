"""Quantized leaf layers (PyTorch port of ``lbt_tpu/nn/layers.py``),
serving forward.  Integer compute is delegated to
:mod:`lbt_tpu_torch.ops.qops`."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from lbt_tpu_torch.config import QuantConfig, carrier_dtype
from lbt_tpu_torch.dfxp.quantize import quantize
from lbt_tpu_torch.nn.core import Layer, check_serving, site_init_exp
from lbt_tpu_torch.ops.qops import qconv2d, qmatmul


def _uniform_(t: torch.Tensor, limit: float, generator) -> None:
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_(u * (2 * limit) - limit)


class _QuantLeaf(Layer):
    """Shared shape of Dense and Conv2d: weight ``W``, optional bias ``b``,
    exponent sites x, w, grad (and b)."""

    def __init__(self, name, cfg, wshape, bits_x, use_bias):
        super().__init__(name, cfg)
        self.use_bias = use_bias
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

    def _bias(self, y: torch.Tensor) -> torch.Tensor:
        if not self.use_bias:
            return y
        return y + quantize(self.b, self.cfg.bits_b, self.exp("b"))


class Dense(_QuantLeaf):
    """Quantized fully-connected layer, ``y = Xq @ Wq + bq``, X at
    ``bits_a`` (dense activations get no extra bit) and W at ``bits_w``;
    ``W`` is ``[in, out]``."""

    def __init__(self, name: str, cfg: QuantConfig, in_units: int,
                 units: int, use_bias: bool = True):
        super().__init__(name, cfg, (in_units, units), cfg.bits_a, use_bias)
        self.in_units = in_units
        self.units = units

    def _fan_limit(self):
        return (6.0 / (self.in_units + self.units)) ** 0.5

    def forward(self, x, ctx):
        check_serving(ctx)
        cfg = self.cfg
        y = qmatmul(x.to(torch.float32), self.W, self.exp("x"),
                    self.exp("w"), bits_x=cfg.bits_a, bits_w=cfg.bits_w)
        return self._bias(y).to(carrier_dtype(cfg))


class Conv2d(_QuantLeaf):
    """Quantized 2-d convolution, NHWC activations and an HWIO ``W``.
    Activations are quantized at ``bits_a + conv_act_extra``, weights at
    ``bits_w``."""

    def __init__(self, name: str, cfg: QuantConfig,
                 ksize: Tuple[int, int, int, int],
                 strides: Tuple[int, int] = (1, 1), padding="SAME",
                 use_bias: bool = True):
        super().__init__(name, cfg, tuple(ksize), cfg.bits_a_conv, use_bias)
        self.ksize = tuple(ksize)  # (kh, kw, Cin, Cout)
        self.strides = tuple(strides)
        self.padding = padding

    def _fan_limit(self):
        kh, kw, cin, _ = self.ksize
        return (3.0 / (kh * kw * cin)) ** 0.5

    def forward(self, x, ctx):
        check_serving(ctx)
        cfg = self.cfg
        y = qconv2d(x.to(torch.float32), self.W, self.exp("x"),
                    self.exp("w"), strides=self.strides,
                    padding=self.padding, bits_x=cfg.bits_a_conv,
                    bits_w=cfg.bits_w)
        return self._bias(y).to(carrier_dtype(cfg))


class ReLU(Layer):
    """``where(x > 0, x, 0)``: the tie rule of lbt_tpu's ReLU."""

    def forward(self, x, ctx):
        return torch.where(x > 0, x, 0.0)


class AvgPool(Layer):
    """Average pooling over NHWC windows, VALID padding: window sums at
    f32 divided by the window size."""

    def __init__(self, name: str = "", *, ksize: Tuple[int, int],
                 strides: Tuple[int, int], padding: str = "VALID"):
        super().__init__(name)
        if padding.upper() != "VALID":
            raise NotImplementedError("only VALID average pooling is ported")
        self.ksize = tuple(ksize)
        self.strides = tuple(strides)
        self.padding = "VALID"

    def forward(self, x, ctx):
        (kh, kw), (sh, sw) = self.ksize, self.strides
        win = x.to(torch.float32).unfold(1, kh, sh).unfold(2, kw, sw)
        return (win.sum(dim=(-2, -1)) / float(kh * kw)).to(x.dtype)


class Flatten(Layer):
    """Reshape to ``[N, dim]`` (NHWC order)."""

    def forward(self, x, ctx):
        return x.reshape(x.shape[0], -1)
