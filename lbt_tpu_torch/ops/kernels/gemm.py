"""K2: int8 x int8 -> int32 GEMM with an optional dequant epilogue.

Replaces ``matmul_int8_pallas`` (``lbt_tpu/ops/pallas/quant_kernels.py``,
``_mm_int8_kernel``).  The kernel is CUDA C++ in
``lbt_tpu_torch/csrc/int8_gemm.cu``; its header says what bounds it on the
H100 and how the design answers that.  It is built with ``nvcc`` for
``sm_90a`` at first use (``build.py``) and called through ``ctypes`` on
PyTorch's current stream.

:func:`int8_matmul` is the wrapper: a CPU tensor takes the plain PyTorch
version :func:`int8_matmul_plain`; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

_INT_MAX = 2 ** 31 - 1


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                      inv_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain PyTorch version of K2 (any device).  Contracts in float64,
    which is exact for int8 codes (|product| <= 2**14, so any K below
    2**38 sums exactly), then rounds like the kernel: int32 accumulator,
    converted to f32, times ``inv_scale``."""
    acc = (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
    if inv_scale is None:
        return acc
    return acc.to(torch.float32) * inv_scale


def _check(a: torch.Tensor, b: torch.Tensor,
           inv_scale: Optional[torch.Tensor]) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"operands must be int8, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"need [M,K] @ [K,N], got {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("operands must be contiguous (row-major)")
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if max(a.shape[0], a.shape[1], b.shape[1]) > _INT_MAX:
        raise ValueError(f"dims above 2**31-1: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if inv_scale is not None and (
            inv_scale.dtype != torch.float32 or inv_scale.numel() != 1
            or inv_scale.device != a.device):
        raise ValueError(
            f"inv_scale must be one float32 element on {a.device}, got "
            f"{inv_scale.dtype} x{inv_scale.numel()} on {inv_scale.device}")


def int8_matmul(a: torch.Tensor, b: torch.Tensor,
                inv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a @ b`` over int8 codes with exact int32 accumulation.

    Returns int32 ``[M, N]`` when ``inv_scale`` is None, else float32
    ``acc * inv_scale`` (``inv_scale`` a one-element f32 tensor on the
    operands' device)."""
    _check(a, b, inv_scale)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b, inv_scale)
    if a.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {a.device}")
    m, k = a.shape
    n = b.shape[1]
    dtype = torch.int32 if inv_scale is None else torch.float32
    if k == 0:
        return torch.zeros((m, n), dtype=dtype, device=a.device)
    out = torch.empty((m, n), dtype=dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    from lbt_tpu_torch.ops.kernels.build import int8_gemm_library
    lib = int8_gemm_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.lbt_int8_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if inv_scale is None else inv_scale.data_ptr(),
            m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"int8 GEMM launch failed: cudaError {rc} "
                           f"at M={m} N={n} K={k}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
