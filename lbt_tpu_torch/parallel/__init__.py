"""Data and tensor parallelism on ``torch.distributed`` (PyTorch port of
``lbt_tpu/parallel``): the process group, the data x model layout and its
sharded weights, the data-parallel train step and the low-bit gradient
all-reduce with error feedback."""

from lbt_tpu_torch.parallel.dp import make_dp_train_step  # noqa: F401
from lbt_tpu_torch.parallel.lowbit import (  # noqa: F401
    init_error_buffers,
    lowbit_allreduce,
    ring_lowbit_allreduce,
)
from lbt_tpu_torch.parallel.mesh import (  # noqa: F401
    gather_params,
    make_groups,
    param_pspecs,
    shard_model,
    shard_params,
)
from lbt_tpu_torch.parallel.multihost import (  # noqa: F401
    Group,
    host_batch_slice,
    initialize,
)
