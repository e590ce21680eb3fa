"""Layer protocol and containers (PyTorch port of ``lbt_tpu/nn/core.py``).

A layer is an ``nn.Module``: trainable tensors are parameters, quantizer
exponents (one int32 scalar per site, buffer ``exp_<site>``) and BN running
statistics are buffers.  ``forward(x, ctx)`` maps activations to
activations.  Layer names, child names and the DFS ``uid`` numbering are
``lbt_tpu``'s, so a layer's path in the port is its path in ``lbt_tpu``'s
params / qstate trees (:mod:`lbt_tpu_torch.convert` walks both).

Only the serving forward is ported: ``Ctx(train=False, update=False)``.
Training behaviour (batch statistics, exponent controllers, cotangent
barriers and their sinks) comes with the training slice and raises
``NotImplementedError`` until then.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from lbt_tpu_torch.config import QuantConfig, check_supported

_RESERVED = {"exp", "state", "grad", "buffer"}


@dataclasses.dataclass
class Ctx:
    """Per-call context.  ``train`` selects behaviour (BN batch statistics),
    ``update`` state mutation (controllers, BN EMA); ``generator`` will
    seed stochastic rounding in training.  Serving is
    ``Ctx(train=False, update=False)``."""

    train: bool
    update: Optional[bool] = None
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        if self.update is None:
            self.update = self.train


def check_serving(ctx: Ctx) -> None:
    if ctx.train or ctx.update:
        raise NotImplementedError(
            "only the serving forward (Ctx(train=False, update=False)) is "
            "ported; training comes with the training slice")


class Layer(nn.Module):
    """Base layer: identity with no state."""

    def __init__(self, name: str = "", cfg: Optional[QuantConfig] = None):
        super().__init__()
        if name in _RESERVED:
            raise ValueError(f"layer name {name!r} is reserved")
        if cfg is not None:
            check_supported(cfg)
        self.name = name
        self.cfg = cfg
        self.uid = -1  # assigned by finalize()

    def forward(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        return x

    def sublayers(self) -> Sequence["Layer"]:
        """Child layers in ``lbt_tpu``'s ``children()`` order."""
        return ()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize this layer's own parameters and state as
        ``lbt_tpu``'s ``init`` does (same distributions, not the same
        numbers)."""

    # -- quantizer exponents ----------------------------------------------
    def _register_exps(self, sites: Iterable[Tuple[str, int, int]]) -> None:
        """One int32 buffer ``exp_<site>`` per (site, bits, initial exp)
        with bits < 32, as ``lbt_tpu``'s ``_init_exps``."""
        self._exp_init: Dict[str, int] = {}
        for site, bits, init in sites:
            if bits < 32:
                self._exp_init[site] = init
                self.register_buffer(
                    f"exp_{site}", torch.tensor(init, dtype=torch.int32))

    def exp_sites(self) -> List[str]:
        return list(getattr(self, "_exp_init", {}))

    def exp(self, site: str):
        """Exponent buffer of ``site``, or 0 for an absent (32-bit) site."""
        return getattr(self, f"exp_{site}", 0)

    def _reset_exps(self) -> None:
        for site, init in getattr(self, "_exp_init", {}).items():
            self.exp(site).fill_(init)


def site_init_exp(cfg: QuantConfig, site: str) -> int:
    if site == "grad" and cfg.initial_exponent_g is not None:
        return cfg.initial_exponent_g
    return cfg.initial_exponent


def finalize(root: Layer) -> Layer:
    """Assign deterministic uids (DFS order) and check name uniqueness."""
    counter = [0]

    def visit(layer: Layer):
        layer.uid = counter[0]
        counter[0] += 1
        names = set()
        for child in layer.sublayers():
            if child.name in names:
                raise ValueError(
                    f"duplicate child name {child.name!r} under "
                    f"{layer.name!r}")
            names.add(child.name)
            visit(child)

    visit(root)
    return root


def auto_name(layers: Sequence[Layer]) -> List[Layer]:
    """Give unnamed layers positional names."""
    for i, layer in enumerate(layers):
        if not layer.name:
            layer.name = f"{i:02d}_{layer.__class__.__name__.lower()}"
    return list(layers)


def walk(root: Layer) -> List[Layer]:
    """Every layer under ``root`` (included), in uid (DFS) order."""
    out = [root]
    for child in root.sublayers():
        out += walk(child)
    return out


class Sequential(Layer):
    """Chain of layers; lbt_tpu's trees nest them by child name."""

    def __init__(self, name: str, layers: Sequence[Layer]):
        super().__init__(name)
        self.layers = nn.ModuleList(auto_name(layers))

    def sublayers(self) -> Sequence[Layer]:
        return tuple(self.layers)

    def forward(self, x, ctx):
        for layer in self.layers:
            x = layer(x, ctx)
        return x
