"""SGD with momentum and the LR schedule (PyTorch port of
``lbt_tpu/train/optim.py``), ``tf.train.MomentumOptimizer`` semantics:

    v <- momentum * v + g
    w <- w - lr * v

Weight decay is in-gradient (``g + 2 * wd * w``), applied by the step
before this update.  Parameters, velocity and gradients are dicts keyed by
the parameter's name in ``model.net.named_parameters()``; the update
writes parameters and velocity in place (the same operations in the same
order as ``lbt_tpu``'s functional update).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

Tensors = Dict[str, torch.Tensor]


def momentum_init(params: Mapping[str, torch.Tensor]) -> Tensors:
    return {k: torch.zeros_like(p, requires_grad=False)
            for k, p in params.items()}


@torch.no_grad()
def momentum_update(params: Mapping[str, torch.Tensor], velocity: Tensors,
                    grads: Mapping[str, torch.Tensor], lr: float,
                    momentum: float) -> None:
    for k, p in params.items():
        v = velocity[k]
        v.copy_(momentum * v + grads[k])
        p.copy_(p - lr * v)


def apply_weight_decay(grads: Mapping[str, torch.Tensor],
                       params: Mapping[str, torch.Tensor],
                       decays: Mapping[str, float]) -> Tensors:
    """The reference's in-gradient L2: ``g + 2 * wd * w`` where
    ``wd != 0``."""
    return {k: (g + (2.0 * decays[k]) * params[k].detach())
            if decays[k] else g for k, g in grads.items()}


def piecewise_lr(base_lr: float, decay_factor: float,
                 decay_epochs: Sequence[int], epoch: int,
                 warmup_epochs: int = 0) -> float:
    """Host-side LR for an epoch: a linear warmup over ``warmup_epochs``,
    then ``decay_factor`` at each of ``decay_epochs``."""
    if warmup_epochs > 0 and epoch < warmup_epochs:
        return base_lr * (epoch + 1) / warmup_epochs
    lr = base_lr
    for e in decay_epochs:
        if epoch >= e:
            lr *= decay_factor
    return lr
