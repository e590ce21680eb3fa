"""Tensor parallelism: a data x model layout of ``torch.distributed``
ranks (PyTorch port of ``lbt_tpu/parallel/mesh.py``).

``lbt_tpu`` lays its devices out as a ``data x model`` mesh and shards
the output channels (the last dim) of every large weight over the
``model`` axis; GSPMD partitions the contractions and inserts the
collectives.  Here the world is cut into the same layout by hand
(:func:`make_groups`: rank ``d * model + m``, the model axis the fast
one, as ``lbt_tpu``'s ``reshape(data, model)``), and each model rank
holds columns ``col0 .. col0 + width`` of every weight that
:func:`param_pspecs` shards (:func:`shard_model`).

A sharded ``Dense`` or ``Conv2d`` (``nn/layers.py``, ``ops/qops.py``)
contracts the whole input with its slice of ``W`` and all-gathers the
slices of its output along the channel dim (the join); a sharded conv
fused with its BatchNorm's input (kernels #4 / #5) joins the BN input's
int8 codes and their per-channel moments, so every layer after the join
runs on the whole tensor, as on one rank.  Every route shards: the
integer route (K1, K2, #4 / #5) and the float route (``sim``,
``sim_bf16``, 32-bit or wider operands, a float backward).  The join's
backward takes this rank's columns of the (whole, replicated) cotangent;
the input's gradient is the sum over the model group of each rank's
partial contraction (int32 sums added before the dequantize on the
integer route, f32 on the float route: ``ops/qops.py``); the weight's
gradient is the slice's own.  Every quantity of a slice that
``lbt_tpu`` computes over the whole tensor is the whole tensor's here:
the stochastic codes draw at their counters in the whole tensor (the
column window of ``ops/kernels/quant.Noise``), the controllers read min
of mins and max of maxes (or counts summed) over the model group
(``nn/core.Ctx``), and the low-bit all-reduce's shared exponent takes
the max over the model group first (``parallel/lowbit.py``).  The
integer sums are exact and the statistics are minima, maxima and exact
counts, so on the integer route a step on this layout equals the
one-rank step on the same data bit for bit; the float route's partial
``dx`` add in another order than one rank's contraction, so it equals
it at f32 tolerance.

A Cout that ``model`` does not divide still shards, as GSPMD pads it:
slices of ``ceil(Cout / model)`` columns, the last one shorter.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lbt_tpu_torch.nn.core import walk
from lbt_tpu_torch.parallel.multihost import Group

__all__ = ["Shard", "column_slice", "gather_params", "make_groups",
           "param_pspecs", "shard_model", "shard_params"]

# minimum size before a weight is worth sharding over 'model'
TP_MIN_ELEMS = 32 * 1024


class Shard(NamedTuple):
    """A layer's place in the model group: its ``W`` holds columns
    ``col0 .. col0 + width`` of ``n`` (the whole tensor's last dim)."""
    group: Group
    col0: int
    width: int
    n: int


def make_groups(data: int, model: int, device=None) -> Tuple[Group, Group]:
    """``(data group, model group)`` of this rank in a ``data x model``
    layout of the world: rank ``d * model + m`` is data index ``d``
    (``data_group.rank``) and model index ``m`` (``model_group.rank``).
    Every rank must call it (each group is a ``new_group`` of the world)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * model != world:
        raise ValueError(f"a {data} x {model} layout needs {data * model} "
                         f"ranks, the world has {world}")
    grid = np.arange(world).reshape(data, model)
    mine = {}
    for axis, lines in (("model", list(grid)), ("data", list(grid.T))):
        for line in lines:
            pg = dist.new_group([int(r) for r in line])
            if rank in line:
                mine[axis] = pg
    return (Group(mine["data"], device=device),
            Group(mine["model"], device=device))


def _leaf_name(key) -> str:
    """The leaf's own name: the last part of a dotted parameter name, or
    the key of a nested tree."""
    return str(key).rsplit(".", 1)[-1]


def param_pspecs(params):
    """``lbt_tpu``'s rule, leaf for leaf: a leaf named ``W`` with at
    least 2 dims and at least 32K elements shards its last dim over
    ``model`` (``(None, ..., "model")``), every other is replicated
    (``()``).  ``params`` is a nested dict (``lbt_tpu``'s params tree) or
    a flat one (``named_parameters()``, a state dict) of tensors or
    arrays; the specs have its structure."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = param_pspecs(v)
        elif (_leaf_name(k) == "W" and v.ndim >= 2
              and int(np.prod(v.shape)) >= TP_MIN_ELEMS):
            out[k] = (None,) * (v.ndim - 1) + ("model",)
        else:
            out[k] = ()
    return out


def column_slice(n: int, tp: int, index: int) -> Tuple[int, int]:
    """``(col0, width)`` of model rank ``index`` of ``tp`` in ``n``
    columns: ``ceil(n / tp)`` each, the last slice shorter."""
    w = -(-n // tp)
    col0 = min(index * w, n)
    return col0, min(w, n - col0)


def shard_params(params, pspecs, tp: int, index: int):
    """Model rank ``index``'s slices of a whole ``params`` tree (as
    :func:`param_pspecs`; tensors or arrays, copied)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = shard_params(v, pspecs[k], tp, index)
            continue
        if pspecs[k]:
            col0, width = column_slice(v.shape[-1], tp, index)
            v = v[..., col0:col0 + width]
        out[k] = (v.clone(memory_format=torch.contiguous_format)
                  if isinstance(v, torch.Tensor) else np.array(v))
    return out


def _sharded(params, pspecs, prefix=()):
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _sharded(v, pspecs[k], prefix + (k,))
        elif pspecs[k]:
            yield prefix + (k,), v


def gather_params(params, pspecs, group: Group):
    """The whole tree from each model rank's slices (the inverse of
    :func:`shard_params`): every sharded leaf all-gathered over ``group``
    along its last dim, padded to the widest slice and cut to the whole
    width.  A collective: every rank of ``group`` calls it."""
    leaves = list(_sharded(params, pspecs))
    if not leaves:
        return params
    widths = torch.tensor([v.shape[-1] for _, v in leaves])
    wmax = group.all_reduce(widths, "max", kind="checkpoint")
    total = group.all_reduce(widths, kind="checkpoint")
    whole = {}
    for (path, v), w, n in zip(leaves, wmax.tolist(), total.tolist()):
        t = torch.as_tensor(v)
        pad = torch.zeros((*t.shape[:-1], w), dtype=t.dtype, device=t.device)
        pad[..., :t.shape[-1]] = t
        g = group.all_gather(pad, -1, kind="checkpoint")[..., :n]
        whole[path] = g if isinstance(v, torch.Tensor) else g.numpy()

    def build(tree, prefix=()):
        return {k: build(v, prefix + (k,)) if isinstance(v, dict)
                else whole.get(prefix + (k,), v) for k, v in tree.items()}
    return build(params)


def shard_model(model, group: Group) -> Dict[str, tuple]:
    """Cut ``model`` (whole, as ``Model.init`` or ``convert`` leaves it)
    to model rank ``group.rank``'s slices, in place: every ``W`` that
    :func:`param_pspecs` shards becomes its columns of the whole, and its
    layer gets a :class:`Shard` (``layer.shard``).  Returns the specs of
    ``model.net.named_parameters()``, for the optimizer's state, the
    checkpoint and the converter."""
    named = dict(model.net.named_parameters())
    specs = param_pspecs(named)
    owner = {id(p): (layer, k) for layer in walk(model.net)
             for k, p in layer.named_parameters(recurse=False)}
    for name, p in named.items():
        if not specs[name]:
            continue
        layer, k = owner[id(p)]
        n = p.shape[-1]
        col0, width = column_slice(n, group.world, group.rank)
        if width < 1:
            raise ValueError(f"{name}: {n} columns leave model rank "
                             f"{group.rank} of {group.world} none")
        with torch.no_grad():
            setattr(layer, k, nn.Parameter(
                p[..., col0:col0 + width].clone(
                    memory_format=torch.contiguous_format)))
        layer.shard = Shard(group, col0, width, n)
    return specs
