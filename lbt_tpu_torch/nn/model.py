"""Model wrapper (PyTorch port of ``lbt_tpu/nn/model.py``): a named layer
stack plus classification-head utilities."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.nn.core import Ctx, Layer, Sequential, finalize, walk


class Model:
    """A quantized classifier.  ``net`` is the root ``Sequential`` module
    holding every parameter and buffer; ``apply`` maps NHWC inputs to
    logits.  Loss is mean sparse softmax cross-entropy, accuracy argmax
    top-1."""

    def __init__(self, name: str, layers: Sequence[Layer],
                 input_shape: Tuple[int, ...], num_classes: int,
                 cfg: Optional[QuantConfig] = None):
        self.name = name
        self.net = finalize(Sequential(name, list(layers)))
        self.input_shape = tuple(input_shape)  # per example, no batch dim
        self.num_classes = num_classes
        self.cfg = cfg

    # -- structure ---------------------------------------------------------
    def init(self, generator: torch.Generator) -> "Model":
        """Initialize every layer in uid order from ``generator`` (a CPU
        generator: the same seed gives the same weights on any device)."""
        with torch.no_grad():
            for layer in walk(self.net):
                layer.reset_parameters(generator)
        return self

    def to(self, device) -> "Model":
        self.net.to(device)
        return self

    @property
    def device(self) -> torch.device:
        return next(self.net.buffers()).device

    # -- compute -----------------------------------------------------------
    def apply(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        return self.net(x, ctx)

    def loss_and_acc(self, logits: torch.Tensor, labels: torch.Tensor):
        """(mean softmax CE, top-1 accuracy)."""
        logits = logits.to(torch.float32)
        labels = labels.to(torch.int64)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[:, None])[:, 0]
        loss = torch.mean(logz - ll)
        acc = torch.mean((logits.argmax(dim=-1) == labels).to(torch.float32))
        return loss, acc
