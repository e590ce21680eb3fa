"""Device operations (kernels, copies, fills) a step in the traced
sub-window."""

UNIT = "1/step"


def read(rec):
    p = rec.get("profile")
    if not p or not p["device"]:
        return None
    return len(p["device"]) / p["steps"]
