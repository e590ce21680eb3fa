"""Load ``lbt_tpu`` params / qstate trees into the port's modules.

The trees are ``lbt_tpu``'s nested dicts with numpy arrays at the leaves
(``jax.tree.map(np.asarray, ...)`` of what ``Model.init`` or a checkpoint
gives).  The walk follows the layers: a container's keys are its child
names; a leaf layer's params map to its parameters by name, its
``qstate['exp'][site]`` to the int32 buffer ``exp_<site>`` and its
``qstate['state']`` entries (BN ``mean`` / ``var``) to buffers of the same
name.  Any missing, extra or mis-shaped entry raises ``ValueError``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from lbt_tpu_torch.nn.core import Layer
from lbt_tpu_torch.nn.model import Model


def _keys_match(path: str, what: str, got, want) -> None:
    got, want = set(got), set(want)
    if got != want:
        raise ValueError(
            f"{path}: {what} keys differ: missing {sorted(want - got)}, "
            f"unexpected {sorted(got - want)}")


def _copy(path: str, dst: torch.Tensor, src) -> None:
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(arr.shape)} does not match "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(arr, copy=True)).to(dst.dtype))


def load_jax_numpy(layer: Layer, params: Mapping, qstate: Mapping,
                   path: str = "") -> None:
    """Copy one layer subtree's ``lbt_tpu`` params / qstate into ``layer``."""
    path = f"{path}/{layer.name}"
    children = layer.sublayers()
    if children:
        names = [c.name for c in children]
        _keys_match(path, "params", params, names)
        _keys_match(path, "qstate", qstate, names)
        for child in children:
            load_jax_numpy(child, params[child.name], qstate[child.name],
                           path)
        return
    own_params = dict(layer.named_parameters(recurse=False))
    own_buffers = dict(layer.named_buffers(recurse=False))
    _keys_match(path, "params", params, own_params)
    # quantized layers carry {'exp', 'state'}; stateless ones nothing
    _keys_match(path, "qstate", qstate,
                {"exp", "state"} if layer.cfg is not None else ())
    exps = qstate.get("exp", {})
    state = qstate.get("state", {})
    _keys_match(path, "qstate/exp", exps, layer.exp_sites())
    _keys_match(path, "qstate/state", state,
                set(own_buffers) - {f"exp_{s}" for s in layer.exp_sites()})
    with torch.no_grad():
        for k, v in params.items():
            _copy(f"{path}/{k}", own_params[k], v)
        for site, v in exps.items():
            _copy(f"{path}/exp/{site}", own_buffers[f"exp_{site}"], v)
        for k, v in state.items():
            _copy(f"{path}/state/{k}", own_buffers[k], v)


def from_jax_numpy(model: Model, params: Mapping, qstate: Mapping) -> Model:
    """Load a whole ``lbt_tpu`` model's trees into ``model``; returns it."""
    load_jax_numpy(model.net, params, qstate)
    return model
