"""K1's share of its roofline in the traced sub-window: the yardstick's
least time for every recorded K1 call, over the device time of K1's
launches."""

from portbench.trace import kernel_class
from portbench.yardstick.roofline import quantize_work

UNIT = "%"


def read(rec):
    p = rec.get("profile")
    if not p:
        return None
    ns = sum(e - s for s, e, name in p["device"] if kernel_class(name) == "k1")
    if not ns:
        return None
    bound_ms = sum(quantize_work(n, cb, st, mode).bound_ms
                   for n, cb, st, mode in p["calls"].get("k1", ()))
    return 100.0 * bound_ms / (ns / 1e6)
