"""Model zoo (PyTorch port of ``lbt_tpu/models/zoo.py``): the CIFAR
ResNets (the gradient-buffer option is not ported).  The other
``lbt_tpu`` models are not ported yet."""

from __future__ import annotations

from typing import Callable, Dict

from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.nn.blocks import ResidualBlock
from lbt_tpu_torch.nn.layers import AvgPool, Conv2d, Dense, Flatten, ReLU
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.nn.norm import BatchNorm


def _res_stage(cfg, name, cin, channels, num_blocks, stride, weight_decay):
    blocks = []
    for i in range(1, 1 + num_blocks):
        blocks.append(ResidualBlock(
            f"{name}-{i}", cfg, cin, channels,
            stride=stride if i == 1 else 1, weight_decay=weight_decay))
        cin = channels * ResidualBlock.expansion
    return blocks, cin


def cifar10_resnet(cfg: QuantConfig, depth: int = 20,
                   dropout_keep: float = 0.5, weight_decay: float = 0.0,
                   num_classes: int = 10,
                   gradient_buffer_batch: int = 0) -> Model:
    """CIFAR ResNet-{20,32,44,56}: 3x3x16 bias-free stem + BN + ReLU,
    three stages of basic blocks at 16/32/64 channels (strides 1/2/2), 8x8
    avgpool and a bias-free 64->num_classes head.  ``weight_decay`` is
    every conv's, dense's and BN gamma's in-gradient L2 coefficient.
    ``dropout_keep`` is accepted and unused, as in ``lbt_tpu`` (the CIFAR
    ResNets have no dropout); ``gradient_buffer_batch > 0`` is not ported.
    Parameters are zero until :meth:`Model.init`."""
    if gradient_buffer_batch > 0:
        raise NotImplementedError(
            "gradient_buffer_batch: GradientBuffer is not ported (ROADMAP "
            "queue 1 item 5)")
    if (depth - 2) % 6:
        raise ValueError(f"bad CIFAR resnet depth {depth}")
    n = (depth - 2) // 6
    layers = [
        Conv2d("conv1", cfg, (3, 3, 3, 16), (1, 1), "SAME", use_bias=False,
               weight_decay=weight_decay),
        BatchNorm("conv1-bn", cfg, 16, weight_decay=weight_decay),
        ReLU(),
    ]
    cin = 16
    for channels, stride in ((16, 1), (32, 2), (64, 2)):
        stage, cin = _res_stage(cfg, f"block{channels}", cin, channels, n,
                                stride, weight_decay)
        layers += stage
    layers += [
        AvgPool(ksize=(8, 8), strides=(1, 1), padding="VALID"),
        Flatten(),
        Dense("softmax", cfg, 64, num_classes, use_bias=False,
              weight_decay=weight_decay),
    ]
    return Model(f"cifar10_resnet{depth}", layers, input_shape=(32, 32, 3),
                 num_classes=num_classes, cfg=cfg)


MODEL_REGISTRY: Dict[str, Callable] = {
    f"CIFAR10_Resnet{d}": (lambda cfg, d=d, **kw: cifar10_resnet(cfg, d, **kw))
    for d in (20, 32, 44, 56)
}

# lbt_tpu's other registry entries, not ported yet
NOT_PORTED = ("PI_MNIST", "MNIST", "CIFAR10", "CIFAR10_VGG",
              "VGG16_CIFAR100", "Imagenet_Resnet18", "Imagenet_Resnet50")

# dataset each model trains on (lbt_tpu's MODEL_DATASET)
MODEL_DATASET: Dict[str, str] = {name: "cifar10" for name in MODEL_REGISTRY}


def build_model(name: str, cfg: QuantConfig, **kw) -> Model:
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](cfg, **kw)
