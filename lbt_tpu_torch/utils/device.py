"""Where the port's entry points run: on the card unless asked otherwise,
and in full f32."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.  A CUDA
    device without a card raises: the entry points never fall back to the
    CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}: no CUDA device is available; pass "
            f'device="cpu" to run on the CPU')
    return dev


@contextlib.contextmanager
def full_f32():
    """TF32 off for the calls inside, the process's setting restored after:
    the entry points' f32 contractions run in full f32 on the card (cuDNN
    convs default to TF32), as ``lbt_tpu``'s are f32.  Also a decorator."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
