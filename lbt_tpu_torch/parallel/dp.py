"""The data-parallel train step on ``torch.distributed`` (PyTorch port of
``lbt_tpu/parallel/dp.py``).

Every rank holds the whole model and runs this step on its own rows of
the global batch.  Parameters, exponents, BN statistics and velocity stay
bitwise equal on every rank: the range controllers' statistics are
averaged over the ranks (``Ctx.dist``), BN is sync-BN over the global
batch, the sinks' statistics and GradientBuffer residuals are averaged,
and the gradients are summed, exactly (f32) or through the low-bit
all-reduce with error feedback (``parallel/lowbit.py``).  The loss is
scaled by 1/N before the backward, so the summed gradient is the global
batch's mean-loss gradient.  Only ``ebuf``, the low-bit all-reduce's
residual, is each rank's own.  A step with the controllers gated off
averages no statistics: its reached sinks carry ``HOLD_STATS`` on every
rank.

On a data x model layout (``parallel/mesh.py``) the step's ``dist`` is
the rank's data group and ``tp`` its model group: the ranks of one data
index run one program on the same rows, as ``lbt_tpu``'s per-data-shard
GSPMD program does, so the noise key folds in the data index, and every
sum and mean above is over the data group only (a sharded leaf's
gradient, velocity and ``ebuf`` are its slice's).

The step records the single-device step's ranges (``train/step.py``);
its collectives lie inside ``lbt/step`` and outside every phase range.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from lbt_tpu_torch.config import TrainConfig
from lbt_tpu_torch.dfxp.keys import fold_in
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.parallel.lowbit import (lowbit_allreduce,
                                           ring_lowbit_allreduce)
from lbt_tpu_torch.train.step import (check_step, forward_backward, gate_of,
                                      sgd_update)
from lbt_tpu_torch.utils.device import full_f32
from lbt_tpu_torch.utils.profiling import span

__all__ = ["make_dp_train_step"]


def make_dp_train_step(model: Model, tc: TrainConfig, dist,
                       lowbit_bits: Optional[int] = None,
                       lowbit_wire: Optional[str] = None,
                       tp=None) -> Callable:
    """``step(model, velocity, ebuf, x, y, step, lr, base_key) ->
    {'loss', 'accuracy'}`` of the global batch, on ``dist`` (a
    :class:`~lbt_tpu_torch.parallel.multihost.Group`); ``x``, ``y`` are
    this rank's rows.  ``ebuf`` (``lowbit.init_error_buffers``) is the
    low-bit all-reduce's error feedback, updated in place, and unused
    without ``lowbit_bits``.  ``lowbit_wire`` None sums the codes with
    one all-reduce; ``'int16'`` / ``'int8'`` run the ring at that width.
    The step's noise key is ``fold_in(fold_in(base_key, step), rank)``,
    ``rank`` the data index (``dist.rank``); the controller cadence is
    chosen on the host, as ``lbt_tpu`` picks its gate-on or gate-off
    program.  ``tp`` is the model group of a tensor-parallel layout
    (``model`` cut by ``parallel.mesh.shard_model``), or None."""
    gate = gate_of(model)
    decays = dict(model.decays())
    n_uids = model.num_layers()
    world = dist.world

    @full_f32()
    def dp_step(model: Model, velocity: Dict[str, torch.Tensor],
                ebuf: Dict[str, torch.Tensor], x: torch.Tensor,
                y: torch.Tensor, step: int, lr: float,
                base_key) -> Dict[str, torch.Tensor]:
        with span("lbt/step"):
            key = fold_in(fold_in(np.asarray(base_key), step), dist.rank)
            ctx = Ctx(train=True, key=key, update=True,
                      update_gate=gate(step), sinks=model.make_sinks(),
                      n_uids=n_uids, dist=dist)
            loss, acc, stats = forward_backward(
                model, ctx, x, y, divisor=float(world))
            with torch.no_grad():
                # gated off, every rank has HOLD_STATS in the same sinks
                # (one graph) and zeros in the rest: their means, with no
                # collective
                if stats and ctx.update_gate:
                    uids = list(stats)
                    stats = dict(zip(uids, dist.mean(
                        torch.stack([stats[u] for u in uids]),
                        kind="stats")))
                with span("lbt/update"):
                    model.absorb_sinks(stats)
                grads = {k: p.grad for k, p in model.net.named_parameters()}
                if lowbit_bits is None:
                    grads = dict(zip(grads, dist.all_reduce_each(
                        list(grads.values()))))
                else:
                    if lowbit_wire is None:
                        grads, new = lowbit_allreduce(
                            grads, ebuf, dist, bits=lowbit_bits, tp=tp)
                    else:
                        grads, new = ring_lowbit_allreduce(
                            grads, ebuf, dist, bits=lowbit_bits,
                            wire=lowbit_wire, tp=tp)
                    for k, v in new.items():
                        ebuf[k].copy_(v)
                # psum of the 1/N-scaled loss, pmean of the accuracy
                la = dist.all_reduce(torch.stack([loss / world, acc]))
            with span("lbt/update"):
                sgd_update(model, velocity, grads, decays, lr, tc.momentum)
            out = {"loss": la[0], "accuracy": la[1] / world}
            check_step(model, velocity, out, step,
                       [(f"ebuf.{k}", v) for k, v in (ebuf or {}).items()])
        return out

    return dp_step

