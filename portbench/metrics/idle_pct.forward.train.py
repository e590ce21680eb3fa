"""The share of the traced sub-window's wall time in which the host was in
the train step's forward and nothing ran on the device: the union of the
program's ``lbt/forward`` ranges (the model and the loss,
``train/step.py:forward_backward``) less the device intervals, over the
sub-window's wall seconds.  ``idle_pct.backward.train`` and
``idle_pct.update.train`` read the other phases the same way; the three
share ``device_idle_pct.train``'s denominator, so their sum is at most
that share, and the rest is idle time outside the phases (the Trainer's
loop between steps, the harness's waits at the sub-window's edges).

None without an ``lbt/step`` range (a program without the ranges) or
without a device trace."""

import numpy as np

from portbench.trace import merged

UNIT = "%"


def phase_idle_pct(rec, phase):
    """The idle share within the union of the host ranges named
    ``phase``."""
    p = rec.get("profile")
    if not p or not p["device"] or p["wall_s"] <= 0:
        return None
    if not any(n == "lbt/step" for _, _, n in p["host"]):
        return None
    busy = np.array(merged(p["device"]), dtype=np.int64)
    idle = 0
    for s, e in merged([h for h in p["host"] if h[2] == phase]):
        over = np.minimum(busy[:, 1], e) - np.maximum(busy[:, 0], s)
        idle += e - s - int(over[over > 0].sum())
    return 100.0 * idle / 1e9 / p["wall_s"]


def read(rec):
    return phase_idle_pct(rec, "lbt/forward")
