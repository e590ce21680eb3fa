"""Carry ``lbt_tpu`` params / qstate / velocity trees into the port's
modules and back.

The trees are ``lbt_tpu``'s nested dicts with numpy arrays at the leaves
(``jax.tree.map(np.asarray, ...)`` of what ``Model.init`` or a checkpoint
gives).  The walk follows the layers: a container's keys are its child
names; a leaf layer's params map to its parameters by name, its
``qstate['exp'][site]`` to the int32 buffer ``exp_<site>`` and its
``qstate['state']`` entries (BN ``mean`` / ``var``, a GradientBuffer's
``buffer``) to buffers of the same name.  A folded model
(``infer.fold_batchnorm``) is a model like any other: its trees are
``lbt_tpu``'s folded trees.  Any missing, extra or mis-shaped entry raises ``ValueError``.
The momentum velocity has the params tree's layout in ``lbt_tpu`` and is a
dict keyed by parameter name (``model.net.named_parameters()``) in the
port (:mod:`lbt_tpu_torch.train.optim`); so is the data-parallel step's
error-feedback ``ebuf`` (:mod:`lbt_tpu_torch.parallel.lowbit`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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
                   path: str = "", velocity: Optional[Mapping] = None,
                   velocity_out: Optional[Dict[int, torch.Tensor]] = None
                   ) -> None:
    """Copy one layer subtree's ``lbt_tpu`` params / qstate into ``layer``;
    with ``velocity`` (params layout) also fill ``velocity_out``
    (``id(parameter) -> tensor``)."""
    path = f"{path}/{layer.name}"
    children = layer.sublayers()
    if children:
        names = [c.name for c in children]
        _keys_match(path, "params", params, names)
        _keys_match(path, "qstate", qstate, names)
        if velocity is not None:
            _keys_match(path, "velocity", velocity, names)
        for child in children:
            load_jax_numpy(child, params[child.name], qstate[child.name],
                           path, None if velocity is None
                           else velocity[child.name], velocity_out)
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
    if velocity is not None:
        _keys_match(path, "velocity", velocity, own_params)
    with torch.no_grad():
        for k, v in params.items():
            _copy(f"{path}/{k}", own_params[k], v)
        for site, v in exps.items():
            _copy(f"{path}/exp/{site}", own_buffers[f"exp_{site}"], v)
        for k, v in state.items():
            _copy(f"{path}/state/{k}", own_buffers[k], v)
        for k, v in (velocity or {}).items():
            dst = torch.zeros_like(own_params[k]).detach()
            _copy(f"{path}/velocity/{k}", dst, v)
            velocity_out[id(own_params[k])] = dst


def from_jax_numpy(model: Model, params: Mapping, qstate: Mapping,
                   velocity: Optional[Mapping] = None,
                   ebuf: Optional[Mapping] = None):
    """Load a whole ``lbt_tpu`` model's trees into ``model``.  Returns
    ``model``, or ``(model, velocity)`` when a velocity tree is given, the
    port's velocity on the model's device, or ``(model, velocity, ebuf)``
    when an ``ebuf`` tree (params layout) is given too."""
    def named(tree):
        by_id: Dict[int, torch.Tensor] = {}
        load_jax_numpy(model.net, params, qstate, velocity=tree,
                       velocity_out=by_id)
        return {name: by_id[id(p)]
                for name, p in model.net.named_parameters()}

    if velocity is None:
        load_jax_numpy(model.net, params, qstate)
        return model
    if ebuf is None:
        return model, named(velocity)
    return model, named(velocity), named(ebuf)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def dump_jax_numpy(layer: Layer, velocity_by_id=None):
    """One layer subtree as ``lbt_tpu`` ``(params, qstate, velocity)``
    trees of numpy arrays (``velocity`` None without ``velocity_by_id``)."""
    children = layer.sublayers()
    if children:
        sub = {c.name: dump_jax_numpy(c, velocity_by_id) for c in children}
        return ({k: v[0] for k, v in sub.items()},
                {k: v[1] for k, v in sub.items()},
                None if velocity_by_id is None
                else {k: v[2] for k, v in sub.items()})
    own = dict(layer.named_parameters(recurse=False))
    params = {k: _numpy(p) for k, p in own.items()}
    qstate = {}
    if layer.cfg is not None:
        sites = layer.exp_sites()
        qstate = {"exp": {s: _numpy(layer.exp(s)) for s in sites},
                  "state": {k: _numpy(b) for k, b in
                            layer.named_buffers(recurse=False)
                            if k not in {f"exp_{s}" for s in sites}}}
    velocity = None
    if velocity_by_id is not None:
        velocity = {k: _numpy(velocity_by_id[id(p)]) for k, p in own.items()}
    return params, qstate, velocity


def to_jax_numpy(model: Model, velocity: Optional[Mapping] = None,
                 ebuf: Optional[Mapping] = None):
    """``(params, qstate, velocity)`` of ``model`` as ``lbt_tpu`` trees of
    numpy arrays; ``velocity`` (the port's dict) becomes a params-layout
    tree, or None when not given.  With ``ebuf`` (a dict like
    ``velocity``) its params-layout tree comes fourth."""
    named = dict(model.net.named_parameters())

    def by_id(tensors, what):
        if tensors is None:
            return None
        _keys_match(what, "parameter", tensors, named)
        return {id(named[k]): v for k, v in tensors.items()}

    out = dump_jax_numpy(model.net, by_id(velocity, "velocity"))
    if ebuf is None:
        return out
    return (*out, dump_jax_numpy(model.net, by_id(ebuf, "ebuf"))[2])
