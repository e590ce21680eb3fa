"""How ``correct`` is decided for a training cell: the program's first
steps against the plain reference's from the same weights, keys and
batches.

Readings of a run of ``k`` steps (program or reference alike):

- ``loss``: each step's loss;
- ``grad``: each leaf's norm of the first gradient as the optimizer gets
  it, the velocity after step 1 (weight decay included);
- ``change``: each leaf's norm of its change over the ``k`` steps;
- ``bn``: each BN running statistic's norm of its change over the steps.

The numbers compared, each against its limit (``portbench/limits``):

- ``loss``: the largest gap of a step's loss, over the reference's;
- ``grad``, ``change``, ``bn``: the worst leaf's gap between the two norms,
  over the larger of the reference's norm of that leaf and of the median
  leaf.  Leaves whose first gradient in the reference lies under a
  thousandth of the median leaf's (moved by round-off alone) are left out
  of ``grad`` and ``change``.

Exponents that differ after the steps are counted beside them, not
compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

NUMBERS = ("loss", "grad", "change", "bn")
ROUND_OFF = 1e-3


def norms(tensors: Dict[str, torch.Tensor], base=None) -> Dict[str, float]:
    """Each tensor's L2 norm (of its difference from ``base[k]``), in
    float64, read in one host transfer."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(
        (tensors[k].detach() - (0 if base is None else base[k])).to(
            torch.float64)) for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def _worst(got: Dict[str, float], want: Dict[str, float], leaves):
    med = statistics.median(want[k] for k in leaves)
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med, 1e-300)
            for k in leaves}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def numbers(got: Dict, want: Dict) -> Dict[str, Dict]:
    """The compared numbers of readings ``got`` against the reference's
    ``want``: ``{name: {"value": v, "leaf": worst leaf or step}}``, and
    ``exps_differ``."""
    if len(got["loss"]) != len(want["loss"]):
        raise ValueError("readings of different step counts")
    gap = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(got["loss"], want["loss"])]
    i = max(range(len(gap)), key=gap.__getitem__)
    med = statistics.median(want["grad"].values())
    moved = [k for k, v in want["grad"].items() if v >= ROUND_OFF * med]
    out = {"loss": {"value": gap[i], "leaf": f"step {i + 1}"}}
    for name, leaves in (("grad", moved), ("change", moved),
                         ("bn", list(want["bn"]))):
        v, k = _worst(got[name], want[name], leaves)
        out[name] = {"value": v, "leaf": k}
    out["exps_differ"] = sum(got["exps"][k] != v
                             for k, v in want["exps"].items())
    return out


def judge(nums: Dict[str, Dict], limits: Dict[str, float]) -> bool:
    """Whether every compared number lies within its limit (a NaN does
    not)."""
    return all(nums[k]["value"] <= limits[k] for k in limits)


def lines(nums: Dict[str, Dict], limits: Dict[str, float]) -> List[str]:
    return [f"check {k}: {nums[k]['value']!r} limit {limits[k]!r} "
            f"({nums[k]['leaf']})" for k in limits]
