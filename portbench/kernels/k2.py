"""K2's AB form, the int8 GEMM (``ops/kernels/gemm.py``,
``csrc/int8_gemm.cu``), as the contractions call it (``ops/qops.py``).
Its roofline is in ``int8mm_roofline``."""

WRAPS = (("lbt_tpu_torch.ops.qops", "int8_matmul"),)
COUNTERS = {"k2": ("lbt_tpu_torch.ops.kernels.gemm", "int8_matmul")}
CLASS = "k2"
DEVICE_NAMES = ("int8_gemm_kernel",)


def record(out, a, b, inv_scale=None):
    """``(M, K, N, scaled)``, the arguments of
    ``yardstick.roofline.gemm_work``."""
    return (a.shape[0], a.shape[1], b.shape[1], inv_scale is not None)
