"""Model wrapper (PyTorch port of ``lbt_tpu/nn/model.py``): a named layer
stack plus classification-head utilities."""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.nn import core
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
        # an FP32 MLP holds parameters and no buffer
        return next(itertools.chain(self.net.buffers(),
                                    self.net.parameters())).device

    def num_layers(self) -> int:
        return len(walk(self.net))

    # -- training structure ------------------------------------------------
    def make_sinks(self) -> Dict[int, torch.Tensor]:
        return core.make_sinks(self.net, self.device)

    def absorb_sinks(self, stats: Dict[int, torch.Tensor]) -> None:
        self.net.absorb_sinks(stats)

    def decay_tree(self) -> Dict:
        return self.net.decay_tree()

    def decays(self) -> List[Tuple[str, float]]:
        """``(parameter name in net.named_parameters(), weight decay)``
        for every parameter."""
        owner = {id(p): (layer, k) for layer in walk(self.net)
                 for k, p in layer.named_parameters(recurse=False)}
        return [(name, owner[id(p)][0].own_decay()[owner[id(p)][1]])
                for name, p in self.net.named_parameters()]

    # -- compute -----------------------------------------------------------
    def apply(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        """Logits of ``x``.  Outside training no autograd graph is built:
        nothing differentiates an eval forward."""
        if not ctx.train:
            with torch.no_grad():
                return self.net(x, ctx)
        return self.net(x, ctx)

    def loss_and_acc(self, logits: torch.Tensor, labels: torch.Tensor):
        """(mean softmax CE, top-1 accuracy) of :meth:`per_example`."""
        ce, correct = self.per_example(logits, labels)
        return torch.mean(ce), torch.mean(correct)

    def per_example(self, logits: torch.Tensor, labels: torch.Tensor):
        """(softmax CE, top-1 correct as f32) of each example.  A label
        outside the head is what ``lbt_tpu``'s ``take_along_axis`` makes of
        it: ``-C..-1`` count from the end, any other picks NaN, so the loss
        is NaN while the gradient keeps only that row's ``logz`` part, and
        the example counts as wrong."""
        logits = logits.to(torch.float32)
        labels = labels.to(torch.int64)
        n_classes = logits.shape[-1]
        logz = torch.logsumexp(logits, dim=-1)
        idx = torch.where(labels < 0, labels + n_classes, labels)
        # a one-hot select picks the label's logit exactly (an Inf
        # elsewhere in the row stays out), and its backward needs no
        # scatter (deterministic on the card); a label outside the head
        # selects no column, and no device assert fires
        onehot = idx[:, None] == torch.arange(n_classes,
                                              device=logits.device)
        ll = torch.where(onehot, logits, 0.0).sum(-1)
        ll = torch.where((idx >= 0) & (idx < n_classes), ll,
                         torch.full_like(ll, float("nan")))
        return logz - ll, (logits.argmax(dim=-1) == labels).to(torch.float32)
