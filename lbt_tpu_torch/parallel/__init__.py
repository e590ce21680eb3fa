"""Data parallelism on ``torch.distributed`` (PyTorch port of
``lbt_tpu/parallel``): the process group, the data-parallel train step
and the low-bit gradient all-reduce with error feedback.  Tensor
parallelism (``lbt_tpu/parallel/mesh.py``) is not ported."""

from lbt_tpu_torch.parallel.dp import make_dp_train_step  # noqa: F401
from lbt_tpu_torch.parallel.lowbit import (  # noqa: F401
    init_error_buffers,
    lowbit_allreduce,
    ring_lowbit_allreduce,
)
from lbt_tpu_torch.parallel.multihost import (  # noqa: F401
    Group,
    host_batch_slice,
    initialize,
)
