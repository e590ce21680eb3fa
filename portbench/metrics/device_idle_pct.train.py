"""The share of the traced sub-window's wall time in which nothing ran on
the device: 1 less the union of the device intervals over it."""

from portbench.trace import busy_s

UNIT = "%"


def read(rec):
    p = rec.get("profile")
    if not p or not p["device"] or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy_s(p) / p["wall_s"])
