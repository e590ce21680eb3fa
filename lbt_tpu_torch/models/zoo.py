"""Model zoo (PyTorch port of ``lbt_tpu/models/zoo.py``): the reference's
four small models (the PI-MNIST MLP, LeNet, the CIFAR-10 convnet and VGG),
the CIFAR ResNets (with the error-feedback gradient buffers on request),
the ImageNet ResNets (with the space-to-depth stem on request) and VGG-16
with BN for CIFAR-100, with ``lbt_tpu``'s layer names, so
:mod:`lbt_tpu_torch.convert` carries ``lbt_tpu``'s trees in and out.
Parameters are zero until :meth:`Model.init`."""

from __future__ import annotations

from typing import Callable, Dict

from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.nn.blocks import ResidualBlock, ResidualBottleneck
from lbt_tpu_torch.nn.layers import (AvgPool, Conv2d, Dense, Dropout,
                                     Flatten, GradientBuffer, MaxPool, ReLU,
                                     SpaceToDepth)
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.nn.norm import BatchNorm


def pi_mnist_mlp(cfg: QuantConfig, dropout_keep: float = 0.5,
                 weight_decay: float = 0.0) -> Model:
    """Permutation-invariant MNIST MLP 784-1024-1024-10 with dropout."""
    return Model("pi_mnist", [
        Dense("dense1", cfg, 784, 1024, weight_decay=weight_decay),
        ReLU(),
        Dropout(keep=dropout_keep),
        Dense("dense2", cfg, 1024, 1024, weight_decay=weight_decay),
        ReLU(),
        Dropout(keep=dropout_keep),
        Dense("softmax", cfg, 1024, 10, weight_decay=weight_decay),
    ], input_shape=(784,), num_classes=10, cfg=cfg)


def lenet_mnist(cfg: QuantConfig, dropout_keep: float = 0.5,
                weight_decay: float = 0.0) -> Model:
    """LeNet-style MNIST convnet: biased 5x5 convs (SAME, then VALID) at
    6/16/120 channels with 2x2 max pools, then dense 120-84-10."""
    return Model("lenet_mnist", [
        Conv2d("conv1", cfg, (5, 5, 1, 6), (1, 1), "SAME",
               weight_decay=weight_decay),
        ReLU(),
        MaxPool(ksize=(2, 2), strides=(2, 2), padding="VALID"),
        Conv2d("conv2", cfg, (5, 5, 6, 16), (1, 1), "VALID",
               weight_decay=weight_decay),
        ReLU(),
        MaxPool(ksize=(2, 2), strides=(2, 2), padding="VALID"),
        Conv2d("conv3", cfg, (5, 5, 16, 120), (1, 1), "VALID",
               weight_decay=weight_decay),
        ReLU(),
        Flatten(),
        Dropout(keep=dropout_keep),
        Dense("dense1", cfg, 120, 84, weight_decay=weight_decay),
        ReLU(),
        Dropout(keep=dropout_keep),
        Dense("softmax", cfg, 84, 10, weight_decay=weight_decay),
    ], input_shape=(28, 28, 1), num_classes=10, cfg=cfg)


def cifar10_convnet(cfg: QuantConfig, dropout_keep: float = 0.5,
                    weight_decay: float = 0.0) -> Model:
    """3-stage CIFAR-10 convnet: biased 5x5 SAME convs at 64/128/128
    channels, each with a 3x3/2 SAME max pool, then dense 2048-400-10."""
    layers = []
    cin = 3
    for i, c in enumerate((64, 128, 128), start=1):
        layers += [
            Conv2d(f"conv{i}", cfg, (5, 5, cin, c), (1, 1), "SAME",
                   weight_decay=weight_decay),
            ReLU(),
            MaxPool(ksize=(3, 3), strides=(2, 2), padding="SAME"),
        ]
        if i < 3:
            layers.append(Dropout(keep=dropout_keep))
        cin = c
    layers += [
        Flatten(),
        Dropout(keep=dropout_keep),
        Dense("dense1", cfg, 128 * 4 * 4, 400, weight_decay=weight_decay),
        ReLU(),
        Dropout(keep=dropout_keep),
        Dense("softmax", cfg, 400, 10, weight_decay=weight_decay),
    ]
    return Model("cifar10_convnet", layers, input_shape=(32, 32, 3),
                 num_classes=10, cfg=cfg)


def cifar10_vgg(cfg: QuantConfig, dropout_keep: float = 0.5,
                weight_decay: float = 0.0) -> Model:
    """VGG-style CIFAR-10 net: three stages of two biased 3x3 convs at
    128/256/512 channels and a 3x3/2 SAME max pool, dropout before stages
    2 and 3, then dense 8192-1024-1024-10."""
    layers = []
    cin = 3
    for stage, c in enumerate((128, 256, 512), start=1):
        if stage > 1:
            layers.append(Dropout(keep=dropout_keep))
        layers += [
            Conv2d(f"conv{stage}-1", cfg, (3, 3, cin, c), (1, 1), "SAME",
                   weight_decay=weight_decay),
            ReLU(),
            Conv2d(f"conv{stage}-2", cfg, (3, 3, c, c), (1, 1), "SAME",
                   weight_decay=weight_decay),
            ReLU(),
            MaxPool(ksize=(3, 3), strides=(2, 2), padding="SAME"),
        ]
        cin = c
    layers += [
        Flatten(),
        Dropout(keep=dropout_keep),
        Dense("dense1", cfg, 512 * 4 * 4, 1024, weight_decay=weight_decay),
        ReLU(),
        Dropout(keep=dropout_keep),
        Dense("dense2", cfg, 1024, 1024, weight_decay=weight_decay),
        ReLU(),
        Dropout(keep=dropout_keep),
        Dense("softmax", cfg, 1024, 10, weight_decay=weight_decay),
    ]
    return Model("cifar10_vgg", layers, input_shape=(32, 32, 3),
                 num_classes=10, cfg=cfg)


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
    ResNets have no dropout).  ``gradient_buffer_batch > 0`` inserts a
    :class:`GradientBuffer` after the stem conv and after the head, sized
    for that fixed batch (drop-remainder batches); the stem conv then
    does not fuse with its BN, which no longer follows it."""
    if (depth - 2) % 6:
        raise ValueError(f"bad CIFAR resnet depth {depth}")
    n = (depth - 2) // 6
    gb = gradient_buffer_batch
    layers = [
        Conv2d("conv1", cfg, (3, 3, 3, 16), (1, 1), "SAME", use_bias=False,
               weight_decay=weight_decay),
    ]
    if gb:
        layers.append(GradientBuffer("grad-buffer-stem", cfg,
                                     (gb, 32, 32, 16)))
    layers += [
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
    if gb:
        layers.append(GradientBuffer("grad-buffer-head", cfg,
                                     (gb, num_classes)))
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


def vgg16(cfg: QuantConfig, dropout_keep: float = 0.5,
          weight_decay: float = 0.0, num_classes: int = 100,
          image_size: int = 32) -> Model:
    """VGG-16 (conv configuration D) with BN, for CIFAR-100-class
    mixed-bit-width training (BASELINE.md configuration 3): 13 bias-free
    3x3 SAME convs, each followed by BN and ReLU, in five stages at
    64/128/256/512/512 channels, each stage closed by a 2x2 max pool; then
    dropout, dense 512*f*f->512, ReLU, dropout and the dense head."""
    plan = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    layers = []
    cin, feat = 3, image_size
    for stage, (c, reps) in enumerate(plan, start=1):
        for r in range(1, reps + 1):
            layers += [
                Conv2d(f"conv{stage}-{r}", cfg, (3, 3, cin, c), (1, 1),
                       "SAME", use_bias=False, weight_decay=weight_decay),
                BatchNorm(f"conv{stage}-{r}-bn", cfg, c,
                          weight_decay=weight_decay),
                ReLU(),
            ]
            cin = c
        layers.append(MaxPool(ksize=(2, 2), strides=(2, 2),
                              padding="VALID"))
        feat //= 2
    layers += [
        Flatten(),
        Dropout(keep=dropout_keep),
        Dense("dense1", cfg, 512 * feat * feat, 512,
              weight_decay=weight_decay),
        ReLU(),
        Dropout(keep=dropout_keep),
        Dense("softmax", cfg, 512, num_classes, weight_decay=weight_decay),
    ]
    return Model("vgg16", layers, input_shape=(image_size, image_size, 3),
                 num_classes=num_classes, cfg=cfg)


# lbt_tpu's registry, and the dataset each model trains on
MODEL_REGISTRY: Dict[str, Callable] = {
    "PI_MNIST": pi_mnist_mlp,
    "MNIST": lenet_mnist,
    "CIFAR10": cifar10_convnet,
    "CIFAR10_VGG": cifar10_vgg,
    **{f"CIFAR10_Resnet{d}": (lambda cfg, d=d, **kw:
                              cifar10_resnet(cfg, d, **kw))
       for d in (20, 32, 44, 56)},
    "VGG16_CIFAR100": vgg16,
    **{f"Imagenet_Resnet{d}": (lambda cfg, d=d, **kw:
                               imagenet_resnet(cfg, d, **kw))
       for d in (18, 50)},
}

MODEL_DATASET: Dict[str, str] = {
    "PI_MNIST": "pi_mnist",
    "MNIST": "mnist",
    "CIFAR10": "cifar10",
    "CIFAR10_VGG": "cifar10",
    **{f"CIFAR10_Resnet{d}": "cifar10" for d in (20, 32, 44, 56)},
    "VGG16_CIFAR100": "cifar100",
    "Imagenet_Resnet18": "imagenet",
    "Imagenet_Resnet50": "imagenet",
}


def build_model(name: str, cfg: QuantConfig, **kw) -> Model:
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](cfg, **kw)
