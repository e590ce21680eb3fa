"""K2's X^T.g form, the weight gradient's int8 GEMM
(``ops/kernels/gemm.py``, ``csrc/int8_gemm.cu``), as the contractions'
backward calls it (``ops/qops.py``).  Its roofline is in
``int8mm_roofline``."""

WRAPS = (("lbt_tpu_torch.ops.qops", "int8_matmul_tn"),)
COUNTERS = {"k2_tn": ("lbt_tpu_torch.ops.kernels.gemm", "int8_matmul_tn")}
CLASS = "k2"
DEVICE_NAMES = ("int8_gemm_tn_kernel",)


def record(out, a, b):
    """``(M, K, N)``, the arguments of
    ``yardstick.roofline.gemm_tn_work``."""
    return (a.shape[0], a.shape[1], b.shape[1])
