"""lbt-tpu's PyTorch / CUDA port for NVIDIA Hopper (H100).

A second package beside ``lbt_tpu`` (the JAX reference, which it never
imports apart from the framework-neutral ``lbt_tpu.config``).  Module paths
mirror ``lbt_tpu``'s.  This slice serves the CIFAR ResNets under the
integer engine: ``models.zoo`` builds them, ``infer.Predictor`` serves
them, ``convert`` loads ``lbt_tpu``'s trees.  The hot ops are hand-written
kernels in ``ops/kernels``: K1, DFXP quantize in Triton, and K2, an int8
GEMM with a dequant epilogue in CUDA C++ (``csrc/``), each with a plain
PyTorch version that CPU tensors take.
"""

__version__ = "0.1.0"

from lbt_tpu_torch.config import QuantConfig, TrainConfig  # noqa: F401
