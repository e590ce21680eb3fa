"""A second architecture for the harness's tests: the PI-MNIST MLP
784-1024-1024-10 (the zoo's ``PI_MNIST``, dropout off) as a DFXP training
step in plain PyTorch, on flat f32 inputs ``[b, 784]``.  Its dense sites,
layers and training state are the ResNet reference's; it has no BN.
Imports nothing of the port."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from portbench.reference import resnet


@dataclasses.dataclass(frozen=True)
class Spec:
    sizes: Tuple[int, ...]
    quant: Dict
    lr: float
    momentum: float
    weight_decay: float

    @classmethod
    def from_config(cls, cfg: Dict, **quant_overrides) -> "Spec":
        quant = {k: cfg["quant"][k] for k in resnet.QUANT_KEYS}
        quant.update(quant_overrides)
        t = cfg["train"]
        return cls(tuple(cfg["model"]["sizes"]), quant, t["lr"],
                   t["momentum"], t["weight_decay"])

    carrier = resnet.Spec.carrier
    bits_conv = resnet.Spec.bits_conv


def build(spec: Spec):
    """Dense, ReLU, Dropout (the identity at keep 1), ..., Dense: the
    zoo's layers and uids."""
    b = resnet.Builder()
    makers = []
    for i, (cin, cout) in enumerate(zip(spec.sizes, spec.sizes[1:])):
        if i:
            makers += [lambda p: b.node("relu", p),
                       lambda p: b.node("dropout", p)]
        makers.append(lambda p, cin=cin, cout=cout:
                      b.node("dense", p, cin=cin, cout=cout))
    return b.seq("", makers), b.uid


def leaves(spec: Spec):
    out = []
    for n in resnet.walk(build(spec)[0]):
        if n.kind == "dense":
            cin, cout = n.args["cin"], n.args["cout"]
            out += [(n.path + "W", (cin, cout),
                     math.sqrt(6.0 / (cin + cout)), spec.weight_decay),
                    (n.path + "b", (cout,), 0.0, 0.0)]
    return out


def forward(st, root, x, params):
    for n in root.children:
        if n.kind == "dense":
            x = resnet.dense_fwd(st, n, x, params)
        elif n.kind == "relu":
            x = torch.where(x > 0, x, 0.0)
    return x


def init_params(spec: Spec, gen: torch.Generator, device):
    """Glorot-uniform weights from one draw, biases 0."""
    ls = leaves(spec)
    u = torch.rand(sum(math.prod(s) for _, s, lim, _ in ls if lim),
                   generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, lim, _ in ls:
        if lim:
            n = math.prod(shape)
            out[name] = (u[at:at + n] * (2 * lim) - lim).view(shape)
            at += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def draw(spec: Spec, batch: int, gen: torch.Generator, device):
    x = torch.randn((batch, spec.sizes[0]), generator=gen, device=device,
                    dtype=torch.float32)
    y = torch.randint(0, spec.sizes[-1], (batch,), generator=gen,
                      device=device, dtype=torch.int64)
    return x, y


class Reference(resnet.Reference):
    build = staticmethod(build)
    leaves = staticmethod(leaves)
    forward = staticmethod(forward)
