"""The int8 contractions' share of their roofline in the traced
sub-window: the yardstick's least time for every recorded call of K2 (both
forms) and #4/#5, over the device time of their launches."""

from portbench.trace import kernel_class
from portbench.yardstick.roofline import (conv_fused_work, gemm_tn_work,
                                          gemm_work)

UNIT = "%"


def read(rec):
    p = rec.get("profile")
    if not p:
        return None
    ns = sum(e - s for s, e, name in p["device"]
             if kernel_class(name) in ("k2", "fused"))
    if not ns:
        return None
    calls = p["calls"]
    bound_ms = (sum(gemm_work(*c).bound_ms for c in calls.get("k2", ()))
                + sum(gemm_tn_work(*c).bound_ms
                      for c in calls.get("k2_tn", ()))
                + sum(conv_fused_work(*c).bound_ms
                      for c in calls.get("conv", ())))
    return 100.0 * bound_ms / (ns / 1e6)
