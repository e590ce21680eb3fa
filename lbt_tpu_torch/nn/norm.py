"""Quantized batch normalization as statistics + affine halves
(PyTorch port of the unfused ``BatchNorm`` in ``lbt_tpu/nn/norm.py``),
eval path on running statistics."""

from __future__ import annotations

import torch
from torch import nn

from lbt_tpu_torch.config import QuantConfig, carrier_dtype
from lbt_tpu_torch.dfxp.quantize import quantize
from lbt_tpu_torch.nn.core import Layer, Sequential, check_serving, \
    site_init_exp


class Normalization(Layer):
    """BN statistics half: quantize the input at ``bits_a`` and normalize
    with the running statistics, ``(xq - mean) / sqrt(var + eps)`` — the
    same operations in the same order as lbt_tpu, not ``rsqrt``."""

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
        check_serving(ctx)
        cfg = self.cfg
        xq = quantize(x.to(torch.float32), cfg.bits_a, self.exp("x"))
        y = (xq - self.mean) / torch.sqrt(self.var + self.eps)
        return y.to(carrier_dtype(cfg))


class Rescale(Layer):
    """BN affine half: ``y = Xq * gamma_q + beta_q``, the input at
    ``bits_a`` and gamma, beta at ``bits_b``."""

    def __init__(self, name: str, cfg: QuantConfig, num_features: int):
        super().__init__(name, cfg)
        self.num_features = num_features
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

    def forward(self, x, ctx):
        check_serving(ctx)
        cfg = self.cfg
        xq = quantize(x.to(torch.float32), cfg.bits_a, self.exp("x"))
        gq = quantize(self.gamma, cfg.bits_b, self.exp("gamma"))
        bq = quantize(self.beta, cfg.bits_b, self.exp("beta"))
        return (xq * gq + bq).to(carrier_dtype(cfg))


class BatchNorm(Sequential):
    """Normalization + Rescale, as lbt_tpu's unfused ``BatchNorm``."""

    def __init__(self, name: str, cfg: QuantConfig, num_features: int,
                 eps: float = 1e-5):
        super().__init__(name, [
            Normalization("norm", cfg, num_features, eps),
            Rescale("rescale", cfg, num_features),
        ])
