"""The single-device train and eval steps (PyTorch port of
``lbt_tpu/train/step.py``).

One call runs, eagerly on the model's device with TF32 off
(``utils.device.full_f32``): the forward with the range controllers (new
exponents and BN statistics staged aside), the backward through the
cotangent barriers (their overflow statistics land in the sinks), the
commit of the staged state, ``absorb_sinks`` for the gradient
sites, in-gradient weight decay and momentum SGD.  Parameters, exponent
and BN buffers and the velocity are updated in place.

The controller cadence (``QuantConfig.range_update_every = K``) is a
Python branch: a step with ``step % K == 0`` or ``step <
range_update_warmup_steps`` runs the controllers; any other step runs
with ``update_gate=False`` (forward-site exponents hold, barriers emit
the hold sentinel).  A hold costs no host round trip: the barriers make
the sentinel on the device, and the gradient sites take the same batched
step as on any other step (``nn.core.Layer.absorb_sinks``), which holds
them on it.

:func:`make_scan_train_step` is ``lbt_tpu``'s K-step block (its
``lax.scan``) as a Python loop of the same steps: the same keys, the same
trajectory.

Each train step records its ranges in a running ``torch.profiler``
profile (``utils.profiling.span``): ``lbt/step`` around the step,
``lbt/forward``, ``lbt/backward``, and ``lbt/update`` around the commit
and again around ``absorb_sinks`` and the SGD update.

:func:`debug_nans` is the port's ``jax_debug_nans`` (``main.py
--debug_nans``): while it is on, each step checks its floating outputs for
NaN and raises ``FloatingPointError``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from lbt_tpu_torch.config import TrainConfig
from lbt_tpu_torch.dfxp.keys import fold_in
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.train.optim import apply_weight_decay, momentum_update
from lbt_tpu_torch.utils.device import full_f32
from lbt_tpu_torch.utils.profiling import span

# process-wide, as jax.config's jax_debug_nans is
_DEBUG_NANS = [False]


@contextlib.contextmanager
def debug_nans(on: bool = True):
    """While ``on``, every train and eval step checks each floating output
    (loss, accuracy; after a train step also the parameters, velocity and
    float buffers, BN statistics among them) for NaN and raises
    ``FloatingPointError`` naming the first such tensor and the step: the
    condition under which ``jax_debug_nans`` fails a jitted step.  Inf
    passes, as there (``jax_debug_infs`` is another switch).  Off, a step
    adds no check and no host sync.  The previous setting is restored on
    exit."""
    saved, _DEBUG_NANS[0] = _DEBUG_NANS[0], bool(on)
    try:
        yield
    finally:
        _DEBUG_NANS[0] = saved


def _raise_on_nan(where: str,
                  named: Iterable[Tuple[str, torch.Tensor]]) -> None:
    """One host read of "has a NaN" for every floating tensor of
    ``named``; raises naming the first that has."""
    names, tensors = zip(*[(k, t) for k, t in named
                           if t.is_floating_point()])
    bad = torch.stack([t.isnan().any() for t in tensors]).cpu()
    if bool(bad.any()):
        first = names[int(bad.nonzero()[0, 0])]
        raise FloatingPointError(
            f"invalid value (nan) in {first} after {where} (debug_nans)")


def gate_of(model: Model) -> Callable[[int], bool]:
    """``step -> whether the range controllers run``: the cadence
    ``range_update_every`` after ``range_update_warmup_steps``."""
    cfg = model.cfg
    cadence = cfg.range_update_every if cfg else 1
    warmup = cfg.range_update_warmup_steps if cfg else 0
    return lambda step: cadence == 1 or step % cadence == 0 or step < warmup


def forward_backward(model: Model, ctx: Ctx, x: torch.Tensor,
                     y: torch.Tensor, divisor: float = 1.0):
    """The step's forward and backward of ``loss / divisor`` under ``ctx``
    (its ``sinks`` fresh), the staged state committed.  Returns ``(loss,
    accuracy, sink statistics)``: the statistics are each sink's
    gradient, zero where no cotangent reached it, as ``lbt_tpu``'s would
    read (with the controllers gated off, a reached sink's is the
    ``HOLD_STATS`` its barrier made on the device)."""
    for p in model.net.parameters():
        p.grad = None
    with span("lbt/forward"):
        logits = model.apply(x, ctx)
        loss, acc = model.loss_and_acc(logits, y)
    with span("lbt/backward"):
        (loss / divisor if divisor != 1.0 else loss).backward()
    with span("lbt/update"), torch.no_grad():
        ctx.commit()
        stats = {uid: torch.zeros_like(s) if s.grad is None else s.grad
                 for uid, s in ctx.sinks.items()}
    return loss.detach(), acc.detach(), stats


@torch.no_grad()
def sgd_update(model: Model, velocity: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], decays: Dict[str, float],
               lr: float, momentum: float) -> None:
    """In-gradient weight decay, then momentum SGD, in place; the
    parameters' ``.grad`` cleared."""
    params = dict(model.net.named_parameters())
    grads = apply_weight_decay(grads, params, decays)
    momentum_update(params, velocity, grads, lr, momentum)
    for p in params.values():
        p.grad = None


def check_step(model: Model, velocity, out, step: int, extra=()) -> None:
    """Under :func:`debug_nans`, raise on a NaN in a train step's
    outputs, state, velocity or ``extra`` named tensors."""
    if _DEBUG_NANS[0]:
        _raise_on_nan(f"train step {step}", [
            *out.items(), *model.net.state_dict().items(),
            *((f"velocity.{k}", v) for k, v in velocity.items()), *extra])


def make_train_step(model: Model, tc: TrainConfig) -> Callable:
    """``train_step(model, velocity, x, y, step, lr, base_key) ->
    {'loss', 'accuracy'}`` (0-d device tensors).  ``velocity`` is
    :func:`~lbt_tpu_torch.train.optim.momentum_init` of the parameters;
    ``base_key`` is raw key data, 2 words or 4 (``dfxp.keys.base_key(seed,
    impl)``)."""
    gate = gate_of(model)
    decays = dict(model.decays())
    n_uids = model.num_layers()

    @full_f32()
    def train_step(model: Model, velocity: Dict[str, torch.Tensor],
                   x: torch.Tensor, y: torch.Tensor, step: int, lr: float,
                   base_key) -> Dict[str, torch.Tensor]:
        with span("lbt/step"):
            ctx = Ctx(train=True, key=fold_in(np.asarray(base_key), step),
                      update=True, update_gate=gate(step),
                      sinks=model.make_sinks(), n_uids=n_uids)
            loss, acc, stats = forward_backward(model, ctx, x, y)
            with span("lbt/update"), torch.no_grad():
                model.absorb_sinks(stats)
                sgd_update(model, velocity,
                           {k: p.grad
                            for k, p in model.net.named_parameters()},
                           decays, lr, tc.momentum)
            out = {"loss": loss, "accuracy": acc}
            check_step(model, velocity, out, step)
        return out

    return train_step


def make_scan_train_step(model: Model, tc: TrainConfig, unroll_steps: int,
                         augment: Optional[Callable] = None) -> Callable:
    """``scan_step(model, velocity, xs, ys, step0, lr, base_key[,
    aug_key]) -> {'loss', 'accuracy'}``, each ``[K]``: ``K =
    unroll_steps`` steps of :func:`make_train_step` on ``xs[i], ys[i]``
    (``xs: [K, B, ...]``), step ``step0 + i`` folding its keys as an
    eager step does.  ``augment`` (``(key, x) -> x``) is applied to each
    batch with ``fold_in(aug_key, step0 + i)``, as the Trainer's eager
    loop applies it."""
    train_step = make_train_step(model, tc)

    def scan_step(model: Model, velocity: Dict[str, torch.Tensor],
                  xs: torch.Tensor, ys: torch.Tensor, step0: int, lr: float,
                  base_key, aug_key=None) -> Dict[str, torch.Tensor]:
        if xs.shape[0] != unroll_steps:
            raise ValueError(f"a block of {xs.shape[0]} batches, "
                             f"expected {unroll_steps}")
        ms = []
        for i in range(unroll_steps):
            x = xs[i]
            if augment is not None:
                x = augment(fold_in(aug_key, step0 + i), x)
            ms.append(train_step(model, velocity, x, ys[i], step0 + i, lr,
                                 base_key))
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return scan_step


def make_eval_step(model: Model, faithful_eval: bool = False) -> Callable:
    """``eval_step(model, x, y, key) -> {'loss', 'accuracy', 'count'}``
    (loss and accuracy 0-d device tensors, count the batch size).

    ``key`` is raw key data used as the call's key as it is, not
    folded with a step: the Trainer passes ``fold_in(base_key, 0xE7A1)``
    for every batch, so the layers round stochastically in eval as
    ``lbt_tpu``'s do.  ``faithful_eval`` reproduces the reference's eval
    (batch-statistic BN, ``Ctx(train=True, update=False)``: no EMA, no
    controllers), which also takes the fused conv + BN-input kernels.
    State is never updated, and no autograd graph is built."""
    n_uids = model.num_layers()

    @full_f32()
    @torch.no_grad()
    def eval_step(model: Model, x: torch.Tensor, y: torch.Tensor,
                  key) -> Dict[str, torch.Tensor]:
        ctx = Ctx(train=faithful_eval, key=np.asarray(key), update=False,
                  n_uids=n_uids)
        loss, acc = model.loss_and_acc(model.apply(x, ctx), y)
        if _DEBUG_NANS[0]:
            _raise_on_nan("the eval step",
                          [("loss", loss), ("accuracy", acc)])
        return {"loss": loss, "accuracy": acc, "count": x.shape[0]}

    return eval_step


def make_masked_eval_step(model: Model,
                          faithful_eval: bool = False) -> Callable:
    """The data-parallel eval step (``lbt_tpu``'s ``make_masked_eval_step``):
    ``eval_step(model, x, y, n_valid, key, dist=None, row0=0) ->
    {'loss_sum', 'correct_sum'}`` (0-d f32 device tensors), the softmax CE
    and the correct count summed over the rows of ``x`` whose global index
    ``row0 + i`` lies below ``n_valid``: the global batch is padded to one
    shape and each rank evaluates rows ``row0..`` of it.  ``dist`` and
    ``row0`` go to the :class:`Ctx`: under ``faithful_eval`` BN takes the
    global padded batch's moments, and every rank draws its rows' noise
    where the global batch would.  The mask multiplies, so a NaN loss of a
    valid row (a label outside the head) stays NaN, as in ``lbt_tpu``.
    The caller sums over the ranks and divides by the true count."""
    n_uids = model.num_layers()

    @full_f32()
    @torch.no_grad()
    def eval_step(model: Model, x: torch.Tensor, y: torch.Tensor,
                  n_valid: int, key, dist=None,
                  row0: int = 0) -> Dict[str, torch.Tensor]:
        ctx = Ctx(train=faithful_eval, key=np.asarray(key), update=False,
                  n_uids=n_uids, dist=dist, row0=row0)
        ce, correct = model.per_example(model.apply(x, ctx), y)
        mask = ((torch.arange(x.shape[0], device=ce.device) + row0)
                < n_valid).to(torch.float32)
        out = {"loss_sum": torch.sum(ce * mask),
               "correct_sum": torch.sum(correct * mask)}
        if _DEBUG_NANS[0]:
            _raise_on_nan("the eval step", out.items())
        return out

    return eval_step
