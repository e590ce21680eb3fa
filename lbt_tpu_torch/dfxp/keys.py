"""The threefry2x32 key chain of ``lbt_tpu``, on the host in numpy.

Stochastic rounding in ``lbt_tpu`` draws its noise from a key per site and
step: ``step_key = fold_in(base_key, step)`` (``train/step.py``) and
``site_key = fold_in(fold_in(step_key, uid), site)`` (``nn/core.py``,
``Ctx.layer_key``).  The counter hash then seeds from the site key's two
words (:func:`lbt_tpu_torch.dfxp.quantize.key_seed`), and the ``prng``
noise is the same cipher of each element's index under the site key
(``ops/kernels/quant.py:threefry_uniform_flat``).  Reproducing the
chain bit for bit here is what makes the port's stochastic codes equal to
``lbt_tpu``'s.

A key is its raw data: a ``uint32`` array of shape ``(..., 2)``, as
``jax.random.key_data`` gives for ``impl='threefry2x32'``.  Every function
is vectorised over leading axes, so one step's site keys for every layer
and site come from two numpy calls (:func:`site_keys`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["base_key", "fold_in", "site_keys", "threefry2x32"]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds, JAX's schedule) on
    ``uint32`` arrays; returns the two output words."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def base_key(seed: int) -> np.ndarray:
    """Raw data of ``jax.random.key(seed, impl='threefry2x32')``:
    ``[seed >> 32, seed & 0xFFFFFFFF]`` for ``0 <= seed < 2**31``."""
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return np.array([0, int(seed)], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in`` on raw threefry key data: the cipher of the
    counter ``[0, data]`` under ``key``.  ``key`` is ``(..., 2)``; ``data``
    (non-negative ints below 2**32) broadcasts against ``key[..., 0]``."""
    key = np.asarray(key, np.uint32)
    data = np.asarray(data, np.int64)
    if (data < 0).any() or (data >= 2 ** 32).any():
        raise ValueError("fold_in data must lie in [0, 2**32)")
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          np.zeros(data.shape, np.uint32),
                          data.astype(np.uint32))
    return np.stack(np.broadcast_arrays(y0, y1), axis=-1)


def site_keys(step_key, n_uids: int, n_sites: int) -> np.ndarray:
    """``[n_uids, n_sites, 2]`` table of ``fold_in(fold_in(step_key,
    uid), site)`` for every uid and site index."""
    per_uid = fold_in(step_key, np.arange(n_uids))          # [U, 2]
    return fold_in(per_uid[:, None, :], np.arange(n_sites)[None, :])
