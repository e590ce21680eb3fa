"""DFXP quantization primitives (PyTorch port of ``lbt_tpu/dfxp/quantize.py``).

A tensor is quantized to a ``bits``-wide signed fixed-point grid whose
binary point sits at ``exp`` integer bits: ``multiplier = 2**(bits-1-exp)``,
codes clipped to ``[-2**(bits-1), 2**(bits-1)-1]``, rounded half-to-even
(deterministic) or as ``floor(x*multiplier + U[0,1))`` (stochastic).
``bits >= 32`` is an exact passthrough.

Codes come from kernel K1 (:mod:`lbt_tpu_torch.ops.kernels.quant`).
Stochastic noise is one of ``lbt_tpu``'s XLA streams, drawn from a key's
raw data exactly as ``lbt_tpu`` draws it, so codes match bit for bit:
``jax.random.uniform`` (``backend='xla'``, ``noise_mode='prng'``), which
is threefry under a 2-word key and XLA's Philox stream under a 4-word
``unsafe_rbg`` key, or the ``hash`` / ``hash1`` counter hash
(``'xla_hash'`` / ``'xla_hash1'``), each per element or, with
``noise_shared_axis0``, one draw of ``shape[1:]`` shared along axis 0
(:func:`noise_spec`).

For training: the straight-through estimator (:func:`straight_through`,
:func:`quantize_ste`), the overflow statistics the range controllers read
(:func:`overflow_counts`, :func:`overflow_rates`, and
:func:`overflow_indicators` from the ``[min, max]`` that K1 emits beside
the codes), and the controller step :func:`update_exponent`, each of one
site or of a stack of sites, one a row.  Exponents and statistics stay
device tensors: a controller step needs no host sync.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lbt_tpu_torch.ops.kernels.quant import (HASH, HASH1, RBG, THREEFRY,
                                             Exp, Noise, code_dtype,
                                             hash_uniform_flat, multiplier,
                                             quantize_codes)

__all__ = ["EXP_MIN", "Noise", "code_dtype", "counts_to_rates",
           "dequantize", "hash_uniform", "key_seed", "multiplier",
           "noise_spec", "overflow_counts", "overflow_indicators",
           "overflow_rates", "quantize", "quantize_int", "quantize_ste",
           "straight_through", "update_exponent"]

# Below this exponent the f32 multiplier 2**(bits-1-exp) would overflow.
EXP_MIN = -110

KeyData = Sequence[int]

# lbt_tpu's quantize backends and the noise stream each draws ('pallas'
# off a TPU falls back to 'xla' there)
_BACKEND_MODES = {"xla": THREEFRY, "pallas": THREEFRY, "xla_hash": HASH,
                  "xla_hash1": HASH1}


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


def noise_spec(key: Optional[KeyData], stochastic: bool, backend: str,
               shape: Sequence[int], shared_axis0: bool = False,
               row0: int = 0,
               window: Optional[Tuple[int, int]] = None) -> Optional[Noise]:
    """The :class:`Noise` of a quantize site of ``shape``, or None to
    round to nearest.  ``key`` is raw key data: 2 words (threefry2x32)
    or 4 (unsafe_rbg).  ``backend`` is ``lbt_tpu``'s: ``'xla'`` draws
    ``jax.random.uniform`` under the key (threefry, or XLA's Philox
    stream under a 4-word key), ``'xla_hash'`` / ``'xla_hash1'`` the
    counter hash seeded by :func:`key_seed`.
    ``shared_axis0`` draws ``shape[1:]`` once and broadcasts it along axis
    0 (``lbt_tpu``'s ``_noise``; a 0-d shape draws per element).  ``row0``
    says that the tensor is rows ``row0..`` of a batch along axis 0 and
    draws them as the whole batch's tensor would: each counter moves by
    ``row0 * prod(shape[1:])`` (a whole number of shared draws, so a
    shared draw is unchanged).  A data-parallel eval rank passes its
    first row (``Ctx.row0``), as ``lbt_tpu``'s GSPMD eval draws over the
    global batch; weights and training steps draw at 0.  ``window``
    ``(col0, n_global)`` says that the tensor is columns ``col0..`` of a
    tensor ``n_global`` wide along its last dim (a tensor-parallel rank's
    slice, ``parallel/mesh.py``) and draws them where that tensor would:
    the shared draw, the row offset and every counter are the whole
    tensor's."""
    if not stochastic:
        return None
    if key is None:
        raise ValueError("stochastic quantization requires a PRNG key")
    if backend not in _BACKEND_MODES:
        raise ValueError(f"unknown quantize backend {backend!r}; the port "
                         f"draws noise for {sorted(_BACKEND_MODES)}")
    mode = _BACKEND_MODES[backend]
    col0, n_global = window or (0, 0)
    if window is not None and (col0, n_global) == (0, shape[-1]):
        n_global = 0  # the whole tensor: no window
    if n_global:
        shape = (*shape[:-1], n_global)
    inner = math.prod(shape[1:]) if shared_axis0 and len(shape) else 0
    offset = 0 if inner else row0 * math.prod(shape[1:])
    kd = [int(v) & 0xFFFFFFFF for v in key]
    if len(kd) not in (2, 4):
        raise ValueError(f"key data of {len(kd)} words: 2 is threefry2x32, "
                         f"4 unsafe_rbg")
    if mode != THREEFRY:
        return Noise(mode, key_seed(kd), 0, inner, offset, n_global, col0)
    if len(kd) == 4:
        return Noise(RBG, kd[0], kd[1], inner, offset, n_global, col0,
                     kd[2], kd[3])
    return Noise(mode, kd[0], kd[1], inner, offset, n_global, col0)


def quantize_int(
    x: torch.Tensor,
    bits: int,
    exp: Exp,
    key: Optional[KeyData] = None,
    *,
    stochastic: bool = False,
    backend: str = "xla",
    noise_shared_axis0: bool = False,
    stats: bool = False,
    row0: int = 0,
    window: Optional[Tuple[int, int]] = None,
):
    """Quantize to integer codes: ``(codes, multiplier)`` with
    ``dequantized = codes / multiplier`` and codes in :func:`code_dtype`.

    ``key`` is raw key data (two uint32 words, or four under
    ``unsafe_rbg``); stochastic rounding draws the noise of ``backend``
    (``'xla'``, ``'xla_hash'`` or ``'xla_hash1'``, :func:`noise_spec`),
    shared along axis 0 with
    ``noise_shared_axis0``.  ``bits`` must be < 32.  ``stats=True``
    returns ``(codes, multiplier, minmax)``, ``minmax`` the f32 ``[min,
    max]`` of ``x * multiplier`` from the same K1 pass.  ``row0`` places
    ``x``'s rows in a larger batch's noise, ``window`` its columns in a
    wider tensor's (:func:`noise_spec`)."""
    if bits >= 32:
        raise ValueError("quantize_int needs bits < 32")
    noise = noise_spec(key, stochastic, backend, x.shape, noise_shared_axis0,
                       row0, window)
    x = x.to(torch.float32).contiguous()
    return quantize_codes(x, bits, exp, noise, stats=stats)


def dequantize(codes: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) / mult


def quantize(
    x: torch.Tensor,
    bits: int,
    exp: Exp,
    key: Optional[KeyData] = None,
    *,
    stochastic: bool = False,
    backend: str = "xla",
    noise_shared_axis0: bool = False,
) -> torch.Tensor:
    """Fake-quantize: quantize then dequantize (``bits >= 32`` passes
    ``x`` through)."""
    if bits >= 32:
        return x
    codes, mult = quantize_int(x, bits, exp, key, stochastic=stochastic,
                               backend=backend,
                               noise_shared_axis0=noise_shared_axis0)
    return dequantize(codes, mult)


# ---------------------------------------------------------------------------
# Straight-through estimator
# ---------------------------------------------------------------------------


class _StraightThrough(torch.autograd.Function):
    """Forward returns ``xq``; backward hands the cotangent to ``x``
    untouched (the reference's ``lambda dy: dy``)."""

    @staticmethod
    def forward(ctx, x, xq):
        return xq

    @staticmethod
    def backward(ctx, g):
        return g, None


def straight_through(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """``xq`` in the forward, identity gradient to ``x`` in the backward."""
    if not x.requires_grad:
        return xq
    return _StraightThrough.apply(x, xq)


def quantize_ste(
    x: torch.Tensor,
    bits: int,
    exp: Exp,
    key: Optional[KeyData] = None,
    *,
    stochastic: bool = False,
    backend: str = "xla",
    noise_shared_axis0: bool = False,
    stats: bool = False,
    row0: int = 0,
    window: Optional[Tuple[int, int]] = None,
):
    """Fake-quantize with a straight-through gradient.  ``stats=True``
    returns ``(xq, minmax)`` (``minmax`` as in :func:`quantize_int`);
    ``row0`` and ``window`` as there."""
    if bits >= 32:
        if stats:
            raise ValueError("no statistics of a passthrough site")
        return x
    out = quantize_int(x, bits, exp, key, stochastic=stochastic,
                       backend=backend,
                       noise_shared_axis0=noise_shared_axis0, stats=stats,
                       row0=row0, window=window)
    xq = straight_through(x, dequantize(out[0], out[1]))
    return (xq, out[2]) if stats else xq


# ---------------------------------------------------------------------------
# Overflow measurement + dynamic range controller
# ---------------------------------------------------------------------------


def overflow_counts(x: torch.Tensor, bits: int, exp: Exp) -> torch.Tensor:
    """The counts behind :func:`overflow_rates` (f32 ``(2,)``, exact
    below 2**24 elements): summed over the ranks that hold slices of one
    tensor, they are the whole tensor's."""
    scaled = x.detach().to(torch.float32) * multiplier(bits, exp, x.device)
    limit = float(2 ** (bits - 1))
    over = (scaled >= limit) | (scaled < -limit)
    over2 = (scaled >= limit / 2) | (scaled < -limit / 2)
    return torch.stack([over.to(torch.float32).sum(),
                        over2.to(torch.float32).sum()])


def _reciprocal(numel: int) -> float:
    """``1 / numel`` rounded to f32, as an f32 one divided by ``numel``
    rounds it, as a Python float (exact: it is an f32 value)."""
    return float(np.float32(1.0) / np.float32(max(numel, 1)))


def counts_to_rates(counts: torch.Tensor,
                    numel: Union[int, Sequence[int]]) -> torch.Tensor:
    """Overflow counts of ``numel`` elements as fractions: the exact
    counts times the f32 reciprocal of ``numel``, as XLA's mean rounds.
    ``counts`` is one ``(2,)`` with an int ``numel``, or ``[N, 2]`` with
    one ``numel`` a row.  The reciprocals reach the device as kernel
    arguments, not as a tensor made from Python data."""
    if isinstance(numel, int):
        return counts * _reciprocal(numel)
    return torch.stack(torch._foreach_mul(
        list(counts.unbind(0)), [_reciprocal(n) for n in numel]))


def overflow_rates(x: torch.Tensor, bits: int, exp: Exp) -> torch.Tensor:
    """``[overflow(x), overflow(2x)]``: the fractions of elements whose
    ``x * multiplier`` clips at the full and at half range (f32 ``(2,)``)."""
    return counts_to_rates(overflow_counts(x, bits, exp), x.numel())


def overflow_indicators(minmax: torch.Tensor, bits: int) -> torch.Tensor:
    """The indicator form of the overflow statistics from ``[min, max]``
    of the scaled tensor (``[..., 2]``): ``[any clips at full range, any
    at half]`` as f32 (``lbt_tpu``'s ``overflow_stats`` at a zero
    target)."""
    limit = float(2 ** (bits - 1))
    mn, mx = minmax[..., 0], minmax[..., 1]
    over = (mx >= limit) | (mn < -limit)
    over2 = (mx >= limit / 2) | (mn < -limit / 2)
    return torch.stack([over, over2], dim=-1).to(torch.float32)


def update_exponent(exp: Exp, rates: torch.Tensor, bits: int,
                    target_overflow_rate: float = 0.0) -> torch.Tensor:
    """One controller step: widen (+1) when ``overflow(x)`` exceeds the
    target, tighten (-1) when ``overflow(2x)`` does not, else hold;
    clipped to ``[EXP_MIN, bits - 1]``.  Returns an int32 tensor."""
    exp = torch.as_tensor(exp, device=rates.device).to(torch.int32)
    one = torch.ones((), dtype=torch.int32, device=rates.device)
    delta = torch.where(rates[..., 0] > target_overflow_rate, one,
                        torch.where(rates[..., 1] <= target_overflow_rate,
                                    -one, 0 * one))
    return torch.clamp(exp + delta, EXP_MIN, bits - 1)
