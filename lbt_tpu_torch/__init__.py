"""lbt-tpu's PyTorch / CUDA port for NVIDIA Hopper (H100).

A second package beside ``lbt_tpu`` (the JAX reference, which it never
imports).  Module paths mirror ``lbt_tpu``'s.  The port serves every
model of ``lbt_tpu``'s registry (``infer.Predictor``, with BN folded and
weights exported as integer codes on request) and trains it one step at
a time on one device (``train.step.make_train_step``, the CLI
``python -m lbt_tpu_torch.main``), or data parallel over the ranks of
``torch.distributed`` (``parallel``), under the integer engine or the float
simulation (``sim`` / ``sim_bf16``), with any of ``lbt_tpu``'s noise
streams; ``models.zoo`` builds them and ``convert`` carries ``lbt_tpu``'s
trees in and out.  The hot ops are hand-written CUDA C++ kernels
(``csrc/``, wrapped in ``ops/kernels``): K1, DFXP quantize with min/max,
one launch a call; K2, an int8 GEMM with a split-K ``X^T.g`` form; #4 /
#5, 3x3 and 1x1 convs fused with the next BatchNorm input's quantize and
moments.  Each has a plain PyTorch version that CPU tensors take.
"""

__version__ = "0.2.0"

from lbt_tpu_torch.config import QuantConfig, TrainConfig  # noqa: F401
