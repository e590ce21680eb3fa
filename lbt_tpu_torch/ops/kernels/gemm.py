"""K2: int8 x int8 -> int32 GEMM with an optional dequant epilogue.

Replaces ``matmul_int8_pallas`` (``lbt_tpu/ops/pallas/quant_kernels.py``,
``_mm_int8_kernel``).  The kernel is CUDA C++ in
``lbt_tpu_torch/csrc/int8_gemm.cu``: ``mma.sync`` m16n8k32 int8 tensor-core
tiles fed by a ``cp.async`` pipeline of 16-byte copies, ragged edges
zero-filled in shared memory; the ``X^T . g`` form takes its fragments
with ``ldmatrix .trans`` and adds its split-K partials with coalesced
int64 atomics.  Its header says what bounds it on the H100 (the operands'
bytes), how the design answers that and what it measured.  It is built
with ``nvcc`` for ``sm_90a`` at first use (``build.py``) and called
through ``ctypes`` on PyTorch's current stream.

:func:`int8_matmul` is the wrapper: a CPU tensor takes the plain PyTorch
version :func:`int8_matmul_plain`; a CUDA tensor launches the kernel.

:func:`int8_matmul_tn` is the ``X^T . g`` form that training's weight
gradients need (``lbt_tpu/ops/qops.py``, ``_MM_XG`` and the dW conv):
``A[K, M]`` read transposed times ``B[K, N]``, summed exactly into int64
(plain version :func:`int8_matmul_tn_plain`).  The ``g . W^T`` form meets
only small weights (the 64 x 10 head, conv kernels that are flipped and
reshaped anyway), so its callers copy ``W^T`` into the forward form.
"""

from __future__ import annotations

from typing import Optional

import torch

_INT_MAX = 2 ** 31 - 1
# rows of K summed exactly in int32 before the int64 partials are added
K_CHUNK = 2 ** 16


def split9(xc: torch.Tensor):
    """``c = 2h + l``: int8 planes ``h = floor(c/2)`` and ``l`` in {0, 1}
    of 9-bit codes ``xc`` (int16), which the int8 kernels contract one
    plane at a time; ``2 (h . g) + l . g`` is ``xc . g`` exactly."""
    hi = xc >> 1
    return hi.to(torch.int8), (xc - 2 * hi).to(torch.int8)


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


def int8_matmul_tn_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``X^T . g`` form: ``a[K, M]^T @
    b[K, N]`` as int64, summed in chunks of :data:`K_CHUNK` rows (each
    exact in float64) whose partials add in int64, like the kernel."""
    out = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.int64,
                      device=a.device)
    for k0 in range(0, a.shape[0], K_CHUNK):
        out += (a[k0:k0 + K_CHUNK].to(torch.float64).t()
                @ b[k0:k0 + K_CHUNK].to(torch.float64)).to(torch.int64)
    return out


def _check(a: torch.Tensor, b: torch.Tensor,
           inv_scale: Optional[torch.Tensor], tn: bool = False) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"operands must be int8, got {a.dtype}, {b.dtype}")
    kdim = 0 if tn else 1
    if a.dim() != 2 or b.dim() != 2 or a.shape[kdim] != b.shape[0]:
        form = "[K,M]^T @ [K,N]" if tn else "[M,K] @ [K,N]"
        raise ValueError(
            f"need {form}, got {tuple(a.shape)}, {tuple(b.shape)}")
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


def int8_matmul_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[K, M]^T @ b[K, N]`` over int8 codes, exact, as int64 ``[M, N]``
    (the split-K ``X^T . g`` kernel on a CUDA tensor)."""
    _check(a, b, None, tn=True)
    if a.device.type == "cpu":
        return int8_matmul_tn_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {a.device}")
    k, m = a.shape
    n = b.shape[1]
    out = torch.zeros((m, n), dtype=torch.int64, device=a.device)
    if k == 0 or m == 0 or n == 0:
        return out
    if -(-k // K_CHUNK) > 65535:
        raise ValueError(f"K={k} needs more than 65535 splits")
    from lbt_tpu_torch.ops.kernels.build import int8_gemm_library
    lib = int8_gemm_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.lbt_int8_gemm_tn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"int8 GEMM (X^T.g) launch failed: cudaError "
                           f"{rc} at M={m} N={n} K={k}")
    int8_matmul_tn.launches += 1
    return out


int8_matmul_tn.launches = 0
