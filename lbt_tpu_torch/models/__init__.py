"""Model zoo and registry."""

from lbt_tpu_torch.models.zoo import (  # noqa: F401
    MODEL_DATASET,
    MODEL_REGISTRY,
    build_model,
    cifar10_convnet,
    cifar10_resnet,
    cifar10_vgg,
    imagenet_resnet,
    lenet_mnist,
    pi_mnist_mlp,
    vgg16,
)
