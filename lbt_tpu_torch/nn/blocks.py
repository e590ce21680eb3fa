"""Residual blocks (PyTorch port of ``lbt_tpu/nn/blocks.py``):
``relu(residual(x) + shortcut(x))``, the sum and the ReLU in the carrier
dtype."""

from __future__ import annotations

import torch

from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.nn.core import Layer, Sequential
from lbt_tpu_torch.nn.layers import Conv2d, ReLU
from lbt_tpu_torch.nn.norm import BatchNorm


def _conv_bn(name: str, cfg: QuantConfig, ksize, strides, weight_decay):
    return [Conv2d(name, cfg, ksize, strides, "SAME", use_bias=False,
                   weight_decay=weight_decay),
            BatchNorm(name + "-bn", cfg, ksize[3],
                      weight_decay=weight_decay)]


class ResidualBlock(Layer):
    """Basic 3x3+3x3 residual block, expansion 1.  The shortcut is the
    identity when the shape is kept, else a 1x1 strided conv + BN."""

    expansion = 1

    def __init__(self, name: str, cfg: QuantConfig, in_channels: int,
                 channels: int, stride: int = 1, weight_decay: float = 0.0):
        super().__init__(name, cfg)
        args = (cfg, in_channels, channels, stride, weight_decay)
        self.residual = Sequential("residual", self._residual_layers(*args))
        self.shortcut = Sequential("shortcut", self._shortcut_layers(*args))

    def _residual_layers(self, cfg, cin, c, stride, wd):
        return (_conv_bn("conv1", cfg, (3, 3, cin, c), (stride, stride), wd)
                + [ReLU("relu1")]
                + _conv_bn("conv2", cfg, (3, 3, c, c), (1, 1), wd))

    def _shortcut_layers(self, cfg, cin, c, stride, wd):
        if stride == 1 and cin == self.expansion * c:
            return []
        return _conv_bn("conv", cfg, (1, 1, cin, self.expansion * c),
                        (stride, stride), wd)

    def sublayers(self):
        return (self.residual, self.shortcut)

    def forward(self, x, ctx):
        # where(s > 0, ...): the tie rule of lbt_tpu's join
        s = self.residual(x, ctx) + self.shortcut(x, ctx)
        return torch.where(s > 0, s, 0.0)


class ResidualBottleneck(ResidualBlock):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck, expansion 4."""

    expansion = 4

    def _residual_layers(self, cfg, cin, c, stride, wd):
        return (_conv_bn("conv1", cfg, (1, 1, cin, c), (1, 1), wd)
                + [ReLU("relu1")]
                + _conv_bn("conv2", cfg, (3, 3, c, c), (stride, stride), wd)
                + [ReLU("relu2")]
                + _conv_bn("conv3", cfg, (1, 1, c, self.expansion * c),
                           (1, 1), wd))
