"""The dense layers' quantized matmul (``ops/qops.py:qmatmul``) as
``nn/layers.py`` calls it; it launches K1 and K2 and has no device kernel
or counter of its own."""

WRAPS = (("lbt_tpu_torch.nn.layers", "qmatmul"),)
COUNTERS = {}
CLASS = "qmatmul"
DEVICE_NAMES = ()


def record(out, x, w, *args, **kwargs):
    return (x.shape[0], w.shape[0], w.shape[1])
