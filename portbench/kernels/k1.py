"""K1, the DFXP quantize (``ops/kernels/quant.py``, ``csrc/quantize.cu``),
as every quantizer site calls it (``dfxp/quantize.py``).  Its roofline is
``k1_roofline``'s."""

WRAPS = (("lbt_tpu_torch.dfxp.quantize", "quantize_codes"),)
COUNTERS = {"k1": ("lbt_tpu_torch.ops.kernels.quant", "quantize_codes")}
CLASS = "k1"
DEVICE_NAMES = ("k1_quantize_kernel",)


def record(out, x, bits, exp, noise=None, stats=False):
    """``(elements, bytes a code, statistics taken, noise mode)``, the
    arguments of ``yardstick.roofline.quantize_work``."""
    return (x.numel(), out[0].element_size(), bool(stats),
            0 if noise is None else noise.mode)
