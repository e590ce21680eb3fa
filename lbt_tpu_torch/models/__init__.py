"""Model zoo and registry."""

from lbt_tpu_torch.models.zoo import (  # noqa: F401
    MODEL_REGISTRY,
    build_model,
    cifar10_resnet,
    imagenet_resnet,
)
