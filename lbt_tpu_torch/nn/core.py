"""Layer protocol and containers (PyTorch port of ``lbt_tpu/nn/core.py``).

A layer is an ``nn.Module``: trainable tensors are parameters, quantizer
exponents (one int32 scalar per site, buffer ``exp_<site>``) and BN running
statistics are buffers.  ``forward(x, ctx)`` maps activations to
activations.  Layer names, child names and the DFS ``uid`` numbering are
``lbt_tpu``'s, so a layer's path in the port is its path in ``lbt_tpu``'s
params / qstate trees (:mod:`lbt_tpu_torch.convert` walks both), and its
uid folds into the same site keys.

State updates of a training forward follow ``lbt_tpu``'s functional
order: every exponent is read before its controller steps in that step.
A layer stages the new value of a forward-site exponent or BN statistic
on the :class:`Ctx` (:meth:`Ctx.stage`); the train step commits the
staged values after the backward pass (:meth:`Ctx.commit`), as ``lbt_tpu``
returns ``new_qstate``.  Gradient-site exponents move only in
:meth:`Layer.absorb_sinks`, from the statistics the cotangent barriers
wrote into the sinks (:func:`make_sinks`), or, on a step whose
controllers are gated off, by :func:`hold_exponents` without reading them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.dfxp.barrier import HOLD_STATS, make_sink
from lbt_tpu_torch.dfxp.keys import site_keys
from lbt_tpu_torch.dfxp.quantize import (EXP_MIN, counts_to_rates, multiplier,
                                         overflow_counts, overflow_indicators,
                                         overflow_stats, quantize_ste,
                                         update_exponent)

_RESERVED = {"exp", "state", "grad", "buffer"}
N_SITES = 5  # site indices folded into a layer key: x, w, b, g, dropout


@dataclasses.dataclass
class Ctx:
    """Per-call context.

    ``train`` selects behaviour (BN batch statistics), ``update`` state
    mutation (controllers, BN EMA), ``update_gate`` whether the range
    controllers run this step (``QuantConfig.range_update_every``).
    ``key`` is the step's raw key data (``uint32[2]`` threefry2x32 or
    ``uint32[4]`` unsafe_rbg, see :mod:`lbt_tpu_torch.dfxp.keys`);
    without it quantization rounds
    deterministically.  ``sinks`` maps a layer uid to its stat sink;
    ``n_uids`` sizes the table of site keys built on first use.  Serving
    is ``Ctx(train=False, update=False)``.

    ``dist`` (a :class:`~lbt_tpu_torch.parallel.multihost.Group`, or None
    on one device) is ``lbt_tpu``'s ``psum_axis``: the range controllers'
    statistics are averaged over the ranks and BN takes the moments of the
    global batch.  ``row0`` is the first row of this rank's slice of a
    global batch in a data-parallel eval: the activations' noise is drawn
    there, as ``lbt_tpu``'s GSPMD eval draws over the whole batch.

    Under tensor parallelism ``dist`` is this rank's data group, and a
    controller of a tensor that this rank holds a column slice of (a
    sharded ``W``, the BN input of a sharded conv) reads the whole
    tensor's statistics: :meth:`stage_ctrl` with the model group waits
    for :meth:`commit`, which takes the min of the slices' minima
    and the max of their maxima (or sums their overflow counts) over the
    model group in one all-reduce, then averages over the data group as
    for any site."""

    train: bool
    key: Optional[np.ndarray] = None
    update: Optional[bool] = None
    update_gate: bool = True
    sinks: Optional[Dict[int, torch.Tensor]] = None
    n_uids: int = 0
    dist: Optional[object] = None
    row0: int = 0
    _keys: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    _staged: list = dataclasses.field(default_factory=list, repr=False)
    _ctrl: list = dataclasses.field(default_factory=list, repr=False)
    _sharded: list = dataclasses.field(default_factory=list, repr=False)
    _means: list = dataclasses.field(default_factory=list, repr=False)
    _taken: set = dataclasses.field(default_factory=set, repr=False)

    def __post_init__(self):
        if self.update is None:
            self.update = self.train
        if self.key is not None:
            self.key = np.asarray(self.key, np.uint32)

    @property
    def controls(self) -> bool:
        """Whether the range controllers run in this call."""
        return bool(self.update and self.update_gate)

    def layer_key(self, uid: int, site: int) -> Optional[Tuple[int, ...]]:
        """``fold_in(fold_in(key, uid), site)`` as ints, two or four as
        the key's width, from a table built for every uid and site at
        once (:func:`~lbt_tpu_torch.dfxp.keys.site_keys`)."""
        if self.key is None:
            return None
        if self._keys is None or uid >= self._keys.shape[0]:
            n = max(uid + 1, self.n_uids,
                    0 if self._keys is None else 2 * self._keys.shape[0])
            self._keys = site_keys(self.key, n, N_SITES)
        return tuple(int(v) for v in self._keys[uid, site])

    def sink(self, layer: "Layer") -> Optional[torch.Tensor]:
        """The stat sink of ``layer``'s barrier; a layer reached twice in
        one call raises rather than adding two cotangents' statistics."""
        if self.sinks is None:
            return None
        if layer.uid in self._taken:
            raise RuntimeError(f"layer {layer.name!r} (uid {layer.uid}) "
                               f"reached twice: its sink is taken")
        self._taken.add(layer.uid)
        return self.sinks.get(layer.uid)

    def stage(self, buf: torch.Tensor, value: torch.Tensor,
              mean: bool = False) -> None:
        """Record ``buf``'s value after this step (written by commit).
        ``mean`` marks a value each rank computes from its own rows (a
        GradientBuffer's residual): under ``dist`` the ranks' values are
        averaged before the write, as ``lbt_tpu`` pmeans the sinks'
        cotangents that carry it."""
        if mean and self.dist is not None:
            self._means.append((buf, value.detach()))
        else:
            self._staged.append((buf, value.detach()))

    def stage_ctrl(self, exp: torch.Tensor, rates: torch.Tensor, bits: int,
                   target: float, model=None, numel: int = 0) -> None:
        """Stage a controller step of ``exp`` from this rank's overflow
        ``rates``.  On one device it is staged at once; under ``dist`` the
        rates of every site wait for :meth:`commit`, which averages them
        over the ranks in one all-reduce.  With a ``model`` group (the
        site's tensor is sharded over it) ``rates`` is this rank's
        slice's statistic, ``[min, max]`` of the scaled slice at a zero
        target, else its overflow counts of the whole tensor's ``numel``
        elements, and waits for the model group's."""
        if model is not None:
            self._sharded.append((exp, rates, bits, target, model, numel))
        elif self.dist is None:
            self.stage(exp, update_exponent(exp, rates, bits, target))
        else:
            self._ctrl.append((exp, rates, bits, target))

    def _whole_rates(self) -> None:
        """The sharded sites' statistics over the model group (one MAX
        all-reduce of every ``[-min, max]``, one SUM of every count pair),
        as rates, staged as a whole tensor's would be."""
        group = self._sharded[0][4]
        for zero in (True, False):
            sites = [e for e in self._sharded if (e[3] == 0.0) == zero]
            if not sites:
                continue
            stats = torch.stack([s[1].to(torch.float32) for s in sites])
            if zero:
                stats[:, 0] = -stats[:, 0]
                whole = group.all_reduce(stats, "max", kind="stats")
                whole[:, 0] = -whole[:, 0]
            else:
                whole = group.all_reduce(stats, kind="stats")
            for (exp, _, bits, target, _, numel), w in zip(sites, whole):
                rates = (overflow_indicators(w, bits) if zero else
                         counts_to_rates(w, numel))
                if self.dist is None:
                    exp.copy_(update_exponent(exp, rates, bits, target))
                else:
                    self._ctrl.append((exp, rates, bits, target))
        self._sharded.clear()

    def commit(self) -> None:
        with torch.no_grad():
            if self._sharded:
                self._whole_rates()
            if self._ctrl:
                rates = self.dist.mean(torch.stack(
                    [r.to(torch.float32) for _, r, _, _ in self._ctrl]),
                    kind="stats")
                for (exp, _, bits, target), r in zip(self._ctrl, rates):
                    exp.copy_(update_exponent(exp, r, bits, target))
                self._ctrl.clear()
            if self._means:
                sums = self.dist.all_reduce_each([v for _, v in self._means])
                for (buf, _), total in zip(self._means, sums):
                    buf.copy_(total / self.dist.world)
                self._means.clear()
            for buf, value in self._staged:
                buf.copy_(value)
        self._staged.clear()


class Layer(nn.Module):
    """Base layer: identity with no state."""

    def __init__(self, name: str = "", cfg: Optional[QuantConfig] = None):
        super().__init__()
        if name in _RESERVED:
            raise ValueError(f"layer name {name!r} is reserved")
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

    # -- training structure -------------------------------------------------
    def has_grad_sink(self) -> bool:
        """Whether this layer's barrier writes a stat sink."""
        return "grad" in self.exp_sites()

    def own_decay(self) -> Dict[str, float]:
        """Weight-decay coefficient of each own parameter."""
        return {}

    def decay_tree(self) -> Dict:
        """``lbt_tpu``'s decay tree: own coefficients for a leaf, child
        name -> subtree for a container."""
        children = self.sublayers()
        if children:
            return {c.name: c.decay_tree() for c in children}
        return self.own_decay()

    def absorb_sinks(self, sink_cots: Dict[int, torch.Tensor],
                     held: Iterable[int] = ()) -> None:
        """Step each gradient-site exponent under this layer from its
        sink's cotangent (``uid -> (2,)`` statistics), about ten small
        launches a site.  The sites of ``held`` (uids whose sinks carry
        :data:`~lbt_tpu_torch.dfxp.barrier.HOLD_STATS`: the controllers
        were gated off) read nothing and take that step together, in
        :func:`hold_exponents`."""
        held = set(held)
        holding = []
        for layer in walk(self):
            if not layer.has_grad_sink():
                continue
            if layer.uid in held:
                holding.append(layer)
            elif layer.uid in sink_cots:
                exp = layer.exp("grad")
                exp.copy_(update_exponent(exp, sink_cots[layer.uid],
                                          layer.cfg.bits_g,
                                          layer.cfg.target_overflow_rate))
        hold_exponents(holding)

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

    # -- helpers of quantized layers ---------------------------------------
    def _qkw(self, ctx: Ctx) -> dict:
        """Rounding options: stochastic only with a key (no key =
        serving, round-to-nearest), the noise stream and its sharing."""
        return dict(stochastic=self.cfg.stochastic and ctx.key is not None,
                    backend=self.cfg.quant_backend,
                    noise_shared_axis0=self.cfg.noise_shared_axis0)

    def _ctrl(self, ctx: Ctx, site: str, bits: int, x: torch.Tensor,
              minmax: Optional[torch.Tensor] = None, shard=None) -> None:
        """Stage one controller step of ``site``, measured on the
        pre-quantization tensor ``x`` at the current exponent (from K1's
        ``minmax`` of ``x * multiplier`` when given).  With a ``shard``
        (``parallel.mesh.Shard``) ``x`` / ``minmax`` are of this rank's
        column slice, and the step reads the whole tensor's statistics
        (:meth:`Ctx.stage_ctrl`).  No-op unless the controllers run."""
        if not ctx.controls or bits >= 32 or site not in self.exp_sites():
            return
        target = self.cfg.target_overflow_rate
        exp = self.exp(site)
        if shard is not None:
            if target != 0.0:
                stat = overflow_counts(x, bits, exp)
            elif minmax is not None:
                stat = minmax
            else:
                scaled = x.detach().to(torch.float32) * multiplier(
                    bits, exp, x.device)
                stat = torch.stack([scaled.amin(), scaled.amax()])
            numel = 0 if x is None else x.numel() // shard.width * shard.n
            ctx.stage_ctrl(exp, stat, bits, target, shard.group, numel)
            return
        if minmax is not None and target == 0.0:
            rates = overflow_indicators(minmax, bits)
        else:
            rates = overflow_stats(x, bits, exp, target)
        ctx.stage_ctrl(exp, rates, bits, target)

    def _quant(self, ctx: Ctx, site: str, t: torch.Tensor, bits: int,
               site_idx: int, row0: int = 0) -> torch.Tensor:
        """STE fake-quantize ``t`` at ``site`` with its site key, staging
        the site's controller step; ``row0`` (``ctx.row0`` for a batch of
        activations) places ``t``'s rows in the global batch's noise."""
        if bits >= 32:
            return t
        key = ctx.layer_key(self.uid, site_idx)
        if not ctx.controls:
            return quantize_ste(t, bits, self.exp(site), key, row0=row0,
                                **self._qkw(ctx))
        tq, minmax = quantize_ste(t, bits, self.exp(site), key, stats=True,
                                  row0=row0, **self._qkw(ctx))
        self._ctrl(ctx, site, bits, t, minmax)
        return tq


@functools.cache
def hold_step(target_overflow_rate: float) -> int:
    """The step :func:`~lbt_tpu_torch.dfxp.quantize.update_exponent`
    takes on :data:`~lbt_tpu_torch.dfxp.barrier.HOLD_STATS` at this
    target (0 for a target in [0, 1)): ``update_exponent`` of 0 on the
    host, once a target."""
    return int(update_exponent(0, torch.tensor(HOLD_STATS), 8,
                               target_overflow_rate))


def hold_exponents(layers: Sequence[Layer]) -> None:
    """Give the gradient-site exponent of each of ``layers`` the step that
    ``update_exponent`` gives it on ``HOLD_STATS`` (:func:`hold_step`),
    clamped to ``[EXP_MIN, bits_g - 1]`` as there, with no read of the
    device: a foreach clamp (after an add, at a target outside [0, 1)) of
    every site of one ``bits_g`` and step at once, a few launches in all.
    The clamp still matters: a cold-start ``initial_exponent_g`` may lie
    above ``bits_g - 1``.  ``hold_exponents.held_sites`` counts the sites
    held so."""
    groups: Dict[Tuple[int, int], List[torch.Tensor]] = {}
    for layer in layers:
        cfg = layer.cfg
        groups.setdefault((cfg.bits_g, hold_step(cfg.target_overflow_rate)),
                          []).append(layer.exp("grad"))
    for (bits, step), exps in groups.items():
        if step:
            torch._foreach_add_(exps, step)
        torch._foreach_clamp_min_(exps, EXP_MIN)
        torch._foreach_clamp_max_(exps, bits - 1)
    hold_exponents.held_sites += len(layers)


hold_exponents.held_sites = 0


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


def layer_paths(root: Layer, prefix: str = "") -> List[Tuple[str, Layer]]:
    """``(path, layer)`` for every layer under ``root`` (excluded) in uid
    order; the path joins child names with ``/``, as the layer's keys in
    ``lbt_tpu``'s params / qstate trees."""
    out = []
    for child in root.sublayers():
        path = f"{prefix}{child.name}"
        out.append((path, child))
        out += layer_paths(child, path + "/")
    return out


def make_sinks(root: Layer, device=None) -> Dict[int, torch.Tensor]:
    """A fresh zero stat sink (``requires_grad``) for every layer under
    ``root`` whose barrier writes one, keyed by uid."""
    return {layer.uid: make_sink(device) for layer in walk(root)
            if layer.has_grad_sink()}


class Sequential(Layer):
    """Chain of layers; lbt_tpu's trees nest them by child name.

    In training, a layer that can take over the layer before it
    (``fuses_with``, as BatchNorm takes a conv) runs both through
    ``forward_from``: the fused conv + BN-input kernels."""

    def __init__(self, name: str, layers: Sequence[Layer]):
        super().__init__(name)
        self.layers = nn.ModuleList(auto_name(layers))

    def sublayers(self) -> Sequence[Layer]:
        return tuple(self.layers)

    def forward(self, x, ctx):
        layers = list(self.layers)
        i = 0
        while i < len(layers):
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            if (ctx.train and nxt is not None
                    and hasattr(nxt, "fuses_with")
                    and nxt.fuses_with(layers[i])):
                x = nxt.forward_from(layers[i], x, ctx)
                i += 2
            else:
                x = layers[i](x, ctx)
                i += 1
        return x
