"""DFXP quantization primitives (PyTorch port of ``lbt_tpu/dfxp/quantize.py``).

A tensor is quantized to a ``bits``-wide signed fixed-point grid whose
binary point sits at ``exp`` integer bits: ``multiplier = 2**(bits-1-exp)``,
codes clipped to ``[-2**(bits-1), 2**(bits-1)-1]``, rounded half-to-even
(deterministic) or as ``floor(x*multiplier + U[0,1))`` (stochastic).
``bits >= 32`` is an exact passthrough.

Codes come from kernel K1 (:mod:`lbt_tpu_torch.ops.kernels.quant`).
Stochastic noise is the ``hash`` / ``hash1`` counter hash of ``lbt_tpu``
(``backend='xla_hash'`` / ``'xla_hash1'``), seeded from a key's raw data
exactly as ``lbt_tpu`` seeds it, so codes match bit for bit.  The
straight-through estimator, overflow statistics and the exponent
controller belong to training and are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from lbt_tpu_torch.ops.kernels.quant import (code_dtype, hash_uniform_flat,
                                             quantize_codes)

__all__ = ["EXP_MIN", "code_dtype", "dequantize", "hash_uniform",
           "key_seed", "multiplier", "quantize", "quantize_int"]

# Below this exponent the f32 multiplier 2**(bits-1-exp) would overflow.
EXP_MIN = -110

Exp = Union[int, torch.Tensor]
KeyData = Sequence[int]

_HASH_BACKENDS = {"xla_hash": False, "xla_hash1": True}


def multiplier(bits: int, exp: Exp, device=None) -> torch.Tensor:
    """``2**(bits-1-exp)`` as an exact f32 scalar tensor.

    Built from the IEEE-754 bit pattern, so it is exact on every device
    for ``-126 <= bits-1-exp <= 127`` (every exponent the controller can
    reach, ``EXP_MIN <= exp <= bits-1``), and ``inf`` above that range, as
    ``jnp.ldexp`` gives."""
    exp = torch.as_tensor(exp, device=device).to(torch.int32)
    e = (bits - 1) - exp
    pow2 = ((e.clamp(-126, 127) + 127) << 23).view(torch.float32)
    return torch.where(e > 127, math.inf, pow2)


def key_seed(key: KeyData) -> int:
    """32-bit hash seed of raw PRNG key data: ``kd[0] + kd[-1]*0x9E3779B9``
    mod 2**32 (``lbt_tpu/dfxp/quantize.py:88-89``)."""
    kd = [int(v) & 0xFFFFFFFF for v in key]
    return (kd[0] + kd[-1] * 0x9E3779B9) & 0xFFFFFFFF


def hash_uniform(key: KeyData, shape, light: bool = False,
                 device=None) -> torch.Tensor:
    """Uniform [0, 1) f32 noise of ``shape``, bitwise equal to
    ``lbt_tpu``'s ``hash_uniform`` for the same key data (``light`` =
    the ``hash1`` variant).  The counter is the row-major flat index."""
    n = math.prod(shape)
    return hash_uniform_flat(key_seed(key), n, light, device).view(
        tuple(shape))


def quantize_int(
    x: torch.Tensor,
    bits: int,
    exp: Exp,
    key: Optional[KeyData] = None,
    *,
    stochastic: bool = False,
    backend: str = "xla_hash",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize to integer codes: ``(codes, multiplier)`` with
    ``dequantized = codes / multiplier`` and codes in :func:`code_dtype`.

    ``key`` is raw key data (two uint32 words); stochastic rounding
    draws the counter-hash noise of ``backend`` (``'xla_hash'`` or
    ``'xla_hash1'``).  ``bits`` must be < 32."""
    if bits >= 32:
        raise ValueError("quantize_int needs bits < 32")
    mult = multiplier(bits, exp, x.device)
    seed = None
    if stochastic:
        if key is None:
            raise ValueError("stochastic quantization requires a PRNG key")
        if backend not in _HASH_BACKENDS:
            raise NotImplementedError(
                f"stochastic backend {backend!r} is not ported; the port "
                f"draws noise from {sorted(_HASH_BACKENDS)}")
        seed = key_seed(key)
    x = x.to(torch.float32).contiguous()
    codes = quantize_codes(x, bits, mult, seed,
                           light=_HASH_BACKENDS.get(backend, False))
    return codes, mult


def dequantize(codes: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) / mult


def quantize(
    x: torch.Tensor,
    bits: int,
    exp: Exp,
    key: Optional[KeyData] = None,
    *,
    stochastic: bool = False,
    backend: str = "xla_hash",
) -> torch.Tensor:
    """Fake-quantize: quantize then dequantize (``bits >= 32`` passes
    ``x`` through)."""
    if bits >= 32:
        return x
    codes, mult = quantize_int(x, bits, exp, key, stochastic=stochastic,
                               backend=backend)
    return dequantize(codes, mult)
