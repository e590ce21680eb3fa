"""K1: DFXP quantize to integer codes.

Replaces ``quantize_pallas`` (``lbt_tpu/ops/pallas/quant_kernels.py``,
body ``_quant_kernel`` / ``_quantize_block`` / ``_uniform01``): scale an f32
tensor by the power-of-two multiplier ``2**(bits-1-exp)``, clip to
``[-2**(bits-1), 2**(bits-1)-1]`` and round — half-to-even when
deterministic, ``floor(scaled + u)`` with ``u`` in [0, 1) when stochastic.

On the H100 this is one elementwise pass bound by bytes (4 in, 1-4 out per
element, a handful of ALU ops), so the kernel is a Triton 1-D block loop
over the contiguous flat tensor (``quant_triton.py``): no tiling to think
about, loads and stores as wide as Triton makes them.  Two choices follow
the TPU kernel's design note: the multiplier is computed outside the kernel
exactly (:func:`lbt_tpu_torch.dfxp.quantize.multiplier`) and read from a
one-element device tensor, so no host sync is needed; and the TPU's
hardware PRNG is replaced by the counter hash of ``lbt_tpu``'s
``xla_hash`` / ``xla_hash1`` paths (``dfxp/quantize.py:_hash_uniform``)
over the row-major flat index, so stochastic codes match ``lbt_tpu``
bit for bit.

For the range controllers the same pass can also emit ``[min, max]`` of the
scaled tensor ``x * mult`` (``stats=True``), which is all that
``overflow_stats`` needs at a zero target rate: each block writes its pair
and a one-block second pass reduces them, so the result does not depend on
the order blocks run in.

:func:`quantize_codes` is the wrapper: a CPU tensor takes the plain PyTorch
version :func:`quantize_codes_plain`; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK32 = 0xFFFFFFFF
_INV24 = 2.0 ** -24
# lowbias32 / multiply-xorshift constants of lbt_tpu's counter hash
_HASH_M1 = 0x7FEB352D
_HASH_M2 = 0x846CA68B


def code_dtype(bits: int) -> torch.dtype:
    """Narrowest integer dtype holding ``bits``-wide signed codes."""
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    return torch.int32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 tensors holding uint32 values,
    split in 16-bit halves so no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_uniform_flat(seed: int, n: int, light: bool,
                      device=None) -> torch.Tensor:
    """Uniform [0, 1) f32 noise: the top 24 bits of the uint32 counter
    hash of ``arange(n) ^ seed``, as ``lbt_tpu/dfxp/quantize.py:
    _hash_uniform`` computes it — the lowbias32 finalizer
    (``noise_mode='hash'``) or, with ``light``, one multiply-xorshift
    round (``'hash1'``)."""
    x = torch.arange(n, dtype=torch.int64, device=device) ^ (seed & _MASK32)
    if not light:
        x = x ^ (x >> 16)
    x = _mul32(x, _HASH_M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _HASH_M2)
    if not light:
        x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * _INV24


def quantize_codes_plain(x: torch.Tensor, bits: int, mult: torch.Tensor,
                         seed: Optional[int] = None, light: bool = False,
                         stats: bool = False):
    """Plain PyTorch version of K1 (any device)."""
    limit = float(2 ** (bits - 1))
    scaled = x * mult
    if seed is None:
        codes = torch.round(torch.clamp(scaled, -limit, limit - 1))
    else:
        u = hash_uniform_flat(seed, x.numel(), light, x.device)
        codes = torch.floor(
            torch.clamp(scaled + u.view(x.shape), -limit, limit - 1))
    codes = codes.to(code_dtype(bits))
    if stats:
        return codes, torch.stack([scaled.amin(), scaled.amax()])
    return codes


def quantize_codes(x: torch.Tensor, bits: int, mult: torch.Tensor,
                   seed: Optional[int] = None, light: bool = False,
                   stats: bool = False):
    """DFXP codes of ``x`` (f32, contiguous, any shape) in
    :func:`code_dtype` of ``bits``.

    ``mult`` is the one-element f32 multiplier on ``x``'s device.
    ``seed=None`` rounds half-to-even; an int seed selects stochastic
    rounding with the counter-hash noise (``light`` = ``hash1``).
    ``stats=True`` returns ``(codes, minmax)`` with ``minmax`` the f32
    ``[min, max]`` of ``x * mult`` (``x`` must not be empty)."""
    if not 1 <= bits < 32:
        raise ValueError(f"bits={bits} outside 1..31")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"x must be contiguous float32, got {x.dtype} "
            f"contiguous={x.is_contiguous()}")
    if (mult.dtype != torch.float32 or mult.numel() != 1
            or mult.device != x.device):
        raise ValueError(
            f"mult must be one float32 element on {x.device}, got "
            f"{mult.dtype} x{mult.numel()} on {mult.device}")
    if x.numel() >= 2 ** 32:
        raise ValueError("the hash counter covers at most 2**32 elements")
    if stats and not x.numel():
        raise ValueError("min / max of an empty tensor")
    if x.device.type == "cpu":
        return quantize_codes_plain(x, bits, mult, seed, light, stats)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x.device}")
    out = torch.empty(x.shape, dtype=code_dtype(bits), device=x.device)
    minmax = x.new_empty(2) if stats else None
    if x.numel():
        from lbt_tpu_torch.ops.kernels import quant_triton
        quant_triton.launch(x, mult, out, bits, seed, light, minmax)
        quantize_codes.launches += 1
    return (out, minmax) if stats else out


quantize_codes.launches = 0
