"""Model zoo (PyTorch port of ``lbt_tpu/models/zoo.py``): the CIFAR
ResNets (the gradient-buffer option is not ported) and the ImageNet
ResNets, with the space-to-depth stem on request.  The other ``lbt_tpu``
models are not ported yet."""

from __future__ import annotations

from typing import Callable, Dict

from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.nn.blocks import ResidualBlock, ResidualBottleneck
from lbt_tpu_torch.nn.layers import (AvgPool, Conv2d, Dense, Flatten,
                                     MaxPool, ReLU, SpaceToDepth)
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.nn.norm import BatchNorm


def _res_stage(cfg, name, block_cls, cin, channels, num_blocks, stride,
               weight_decay):
    blocks = []
    for i in range(1, 1 + num_blocks):
        blocks.append(block_cls(
            f"{name}-{i}", cfg, cin, channels,
            stride=stride if i == 1 else 1, weight_decay=weight_decay))
        cin = channels * block_cls.expansion
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
        stage, cin = _res_stage(cfg, f"block{channels}", ResidualBlock,
                                cin, channels, n, stride, weight_decay)
        layers += stage
    layers += [
        AvgPool(ksize=(8, 8), strides=(1, 1), padding="VALID"),
        Flatten(),
        Dense("softmax", cfg, 64, num_classes, use_bias=False,
              weight_decay=weight_decay),
    ]
    return Model(f"cifar10_resnet{depth}", layers, input_shape=(32, 32, 3),
                 num_classes=num_classes, cfg=cfg)


_IMAGENET_STAGES = {
    18: (ResidualBlock, (2, 2, 2, 2)),
    34: (ResidualBlock, (3, 4, 6, 3)),
    50: (ResidualBottleneck, (3, 4, 6, 3)),
    101: (ResidualBottleneck, (3, 4, 23, 3)),
}


def imagenet_resnet(cfg: QuantConfig, depth: int = 50,
                    weight_decay: float = 0.0, num_classes: int = 1000,
                    image_size: int = 224,
                    dropout_keep: float = 1.0) -> Model:
    """ImageNet ResNet-{18,34,50,101}: 7x7/2 bias-free stem + BN + ReLU,
    3x3/2 SAME max pool, four stages at 64/128/256/512 channels (basic
    blocks or bottlenecks; strides 1/2/2/2), global average pool and a
    dense head with bias.  ``dropout_keep`` is accepted and unused, as in
    ``lbt_tpu``.  ``cfg.stem_s2d`` takes the MLPerf space-to-depth stem:
    a 2x2 :class:`SpaceToDepth`, then a 4x4/s1 conv over 12 channels with
    pads (1, 2), into which the 7x7/s2 SAME conv embeds exactly
    (``lbt_tpu/models/zoo.py``).  Parameters are zero until
    :meth:`Model.init`."""
    del dropout_keep
    block_cls, stage_sizes = _IMAGENET_STAGES[depth]
    if cfg.stem_s2d:
        stem = [SpaceToDepth(block=2),
                Conv2d("conv1", cfg, (4, 4, 12, 64), (1, 1),
                       ((1, 2), (1, 2)), use_bias=False,
                       weight_decay=weight_decay)]
    else:
        stem = [Conv2d("conv1", cfg, (7, 7, 3, 64), (2, 2), "SAME",
                       use_bias=False, weight_decay=weight_decay)]
    layers = stem + [
        BatchNorm("conv1-bn", cfg, 64, weight_decay=weight_decay),
        ReLU(),
        MaxPool(ksize=(3, 3), strides=(2, 2), padding="SAME"),
    ]
    cin, feat = 64, image_size // 4
    for i, (channels, blocks) in enumerate(zip((64, 128, 256, 512),
                                               stage_sizes)):
        stride = 1 if i == 0 else 2
        stage, cin = _res_stage(cfg, f"stage{i + 1}", block_cls, cin,
                                channels, blocks, stride, weight_decay)
        layers += stage
        feat = -(-feat // stride)
    layers += [
        AvgPool(ksize=(feat, feat), strides=(1, 1), padding="VALID"),
        Flatten(),
        Dense("softmax", cfg, cin, num_classes, weight_decay=weight_decay),
    ]
    return Model(f"imagenet_resnet{depth}", layers,
                 input_shape=(image_size, image_size, 3),
                 num_classes=num_classes, cfg=cfg)


MODEL_REGISTRY: Dict[str, Callable] = {
    **{f"CIFAR10_Resnet{d}": (lambda cfg, d=d, **kw:
                              cifar10_resnet(cfg, d, **kw))
       for d in (20, 32, 44, 56)},
    **{f"Imagenet_Resnet{d}": (lambda cfg, d=d, **kw:
                               imagenet_resnet(cfg, d, **kw))
       for d in (18, 50)},
}

# lbt_tpu's other registry entries, not ported yet
NOT_PORTED = ("PI_MNIST", "MNIST", "CIFAR10", "CIFAR10_VGG",
              "VGG16_CIFAR100")

# dataset each model trains on (lbt_tpu's MODEL_DATASET)
MODEL_DATASET: Dict[str, str] = {
    name: "imagenet" if name.startswith("Imagenet") else "cifar10"
    for name in MODEL_REGISTRY}


def build_model(name: str, cfg: QuantConfig, **kw) -> Model:
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](cfg, **kw)
