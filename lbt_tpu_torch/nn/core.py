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
A layer stages a BN statistic's new value on the :class:`Ctx`
(:meth:`Ctx.stage`), and what it measured of a forward site's tensor for
that site's controller (:meth:`Layer._ctrl`); the train step commits
both after the backward pass (:meth:`Ctx.commit`), as ``lbt_tpu``
returns ``new_qstate``.  Gradient-site exponents move in
:meth:`Layer.absorb_sinks`, from the statistics the cotangent barriers
wrote into the sinks (:func:`make_sinks`).  Both step their exponents in
one batched pass (:func:`_step`): one ``update_exponent`` of the stacked
exponents of each ``(bits, target)``, whatever the number of sites.
"""

from __future__ import annotations

import dataclasses
from typing import (Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch import nn

from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.dfxp.barrier import make_sink
from lbt_tpu_torch.dfxp.keys import site_keys
from lbt_tpu_torch.dfxp.quantize import (counts_to_rates, multiplier,
                                         overflow_counts, overflow_indicators,
                                         quantize_ste, update_exponent)

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
    tensor's statistics: :meth:`commit` takes the min of the slices'
    minima and the max of their maxima (or sums their overflow counts)
    over the model group in one all-reduce, then averages over the data
    group as for any site."""

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

    def commit(self) -> None:
        with torch.no_grad():
            if self._ctrl:
                self._step_controllers()
            if self._means:
                sums = self.dist.all_reduce_each([v for _, v in self._means])
                for (buf, _), total in zip(self._means, sums):
                    buf.copy_(total / self.dist.world)
                self._means.clear()
            for buf, value in self._staged:
                buf.copy_(value)
        self._staged.clear()

    def _step_controllers(self) -> None:
        """Step every staged controller at once: stack the statistics
        (the unsharded sites in staging order, then the sharded ones at a
        zero target, then the rest); the sharded rows over their model
        group, one MAX all-reduce of ``[-min, max]`` and one SUM of the
        counts; every row as rates; under ``dist`` one mean of the rates
        over the data group; then :func:`_step`."""
        local = [s for s in self._ctrl if s.group is None]
        zero = [s for s in self._ctrl
                if s.group is not None and s.target == 0.0]
        counted = [s for s in self._ctrl
                   if s.group is not None and s.target != 0.0]
        sites = local + zero + counted
        stats = torch.stack([s.stat.to(torch.float32) for s in sites])
        a, b = len(local), len(local) + len(zero)
        if zero:
            # the min of the slices' minima is the max of their negations
            mm = stats[a:b]
            mm[:, 0].neg_()
            mm.copy_(zero[0].group.all_reduce(mm, "max", kind="stats"))
            mm[:, 0].neg_()
        if counted:
            stats[b:].copy_(counted[0].group.all_reduce(stats[b:],
                                                        kind="stats"))
        rates = _rates(sites, stats)
        if self.dist is not None:
            rates = self.dist.mean(rates, kind="stats")
        _step(sites, rates)
        self._ctrl.clear()


class _Site(NamedTuple):
    """A site's exponent buffer, width and target; of a forward site also
    what :meth:`Layer._ctrl` measured and the model group its tensor is
    sharded over (None: whole on this rank)."""
    exp: torch.Tensor
    bits: int
    target: float
    stat: Optional[torch.Tensor] = None
    group: Optional[object] = None
    numel: int = 0


def _by_rule(sites: Sequence[_Site]) -> Dict[Tuple[int, float], List[int]]:
    """The indices of ``sites`` under each ``(bits, target)``, ascending."""
    out: Dict[Tuple[int, float], List[int]] = {}
    for i, s in enumerate(sites):
        out.setdefault((s.bits, s.target), []).append(i)
    return out


def _take(rows: torch.Tensor, idx: List[int]) -> torch.Tensor:
    """Rows ``idx`` (ascending) of ``rows``: ``rows`` itself when they
    are all of them, else one stack of its rows' views."""
    if len(idx) == rows.shape[0]:
        return rows
    views = rows.unbind(0)
    return torch.stack([views[i] for i in idx])


def _rates(sites: Sequence[_Site], stats: torch.Tensor) -> torch.Tensor:
    """Each site's row of ``stats`` as the rates ``update_exponent`` reads
    (``lbt_tpu``'s ``overflow_stats``): the indicators of ``[min, max]``
    at a zero target, else the counts as fractions of ``numel``; the rows
    of each ``(bits, target)`` at once, back in the sites' order."""
    parts = []
    for (bits, target), idx in _by_rule(sites).items():
        rows = _take(stats, idx)
        parts.append((idx, overflow_indicators(rows, bits) if target == 0.0
                      else counts_to_rates(rows, [sites[i].numel
                                                  for i in idx])))
    if len(parts) == 1:
        return parts[0][1]
    out: List[Optional[torch.Tensor]] = [None] * len(sites)
    for idx, rates in parts:
        for i, row in zip(idx, rates.unbind(0)):
            out[i] = row
    return torch.stack(out)


def _step(sites: Sequence[_Site], rates: torch.Tensor) -> None:
    """Step each site's exponent from its row of ``rates`` (``[N, 2]``):
    one ``update_exponent`` (widen, tighten or hold, clamped to
    ``[EXP_MIN, bits - 1]``) of the stacked exponents of each ``(bits,
    target)``, then one foreach copy into the sites' buffers.  Nothing is
    read back to the host and no tensor is made from Python data."""
    exps, new = [], []
    for (bits, target), idx in _by_rule(sites).items():
        group = [sites[i].exp for i in idx]
        exps += group
        new += update_exponent(torch.stack(group), _take(rates, idx), bits,
                               target).unbind(0)
    torch._foreach_copy_(exps, new)


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

    def absorb_sinks(self, stats: Dict[int, torch.Tensor]) -> None:
        """Step the gradient-site exponent of every layer under this one
        whose uid ``stats`` holds from that sink's statistics (``uid ->
        (2,)`` rates; a gated-off barrier's are
        :data:`~lbt_tpu_torch.dfxp.barrier.HOLD_STATS`, on which the step
        holds), all in one batched step (:func:`_step`)."""
        layers = [layer for layer in walk(self)
                  if layer.has_grad_sink() and layer.uid in stats]
        if layers:
            _step([_Site(layer.exp("grad"), layer.cfg.bits_g,
                         layer.cfg.target_overflow_rate) for layer in layers],
                  torch.stack([stats[layer.uid] for layer in layers]))

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
        """Stage one controller step of ``site`` on ``ctx``, for
        :meth:`Ctx.commit`, with what was measured of the
        pre-quantization tensor ``x`` at the current exponent:
        ``[min, max]`` of ``x * multiplier`` at a zero target (K1's
        ``minmax`` when given), else ``x``'s overflow counts.  With a
        ``shard`` (``parallel.mesh.Shard``) ``x`` / ``minmax`` are of this
        rank's column slice, and the step reads the whole tensor's
        statistics over ``shard.group``.  No-op unless the controllers
        run."""
        if not ctx.controls or bits >= 32 or site not in self.exp_sites():
            return
        target = self.cfg.target_overflow_rate
        exp = self.exp(site)
        if target != 0.0:
            stat = overflow_counts(x, bits, exp)
        elif minmax is not None:
            stat = minmax
        else:
            scaled = x.detach().to(torch.float32) * multiplier(
                bits, exp, x.device)
            stat = torch.stack([scaled.amin(), scaled.amax()])
        numel = 0 if x is None else x.numel()
        if shard is not None:
            numel = numel // shard.width * shard.n
        ctx._ctrl.append(_Site(exp, bits, target, stat,
                               None if shard is None else shard.group, numel))

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
