"""Device milliseconds a step of every operation that is not one of the
port's kernels (K1, K2 in both forms, #4/#5): PyTorch's glue, copies and
fills, and under the float route cuDNN's and cuBLAS's contractions."""

from portbench.trace import kernel_class

UNIT = "ms/step"


def read(rec):
    p = rec.get("profile")
    if not p or not p["device"]:
        return None
    ns = sum(e - s for s, e, name in p["device"] if kernel_class(name) is None)
    return ns / 1e6 / p["steps"]
