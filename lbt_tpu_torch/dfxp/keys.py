"""The key chains of ``lbt_tpu``, on the host in numpy.

Stochastic rounding in ``lbt_tpu`` draws its noise from a key per site and
step: ``step_key = fold_in(base_key, step)`` (``train/step.py``) and
``site_key = fold_in(fold_in(step_key, uid), site)`` (``nn/core.py``,
``Ctx.layer_key``).  The counter hash then seeds from the site key's first
and last words (:func:`lbt_tpu_torch.dfxp.quantize.key_seed`), and the
``prng`` noise is the key's own stream of each element's index
(``ops/kernels/quant.py``).  Reproducing the chain bit for bit here is what
makes the port's stochastic codes equal to ``lbt_tpu``'s.

A key is its raw data, as ``jax.random.key_data`` gives it: ``uint32`` of
shape ``(..., 2)`` for ``impl='threefry2x32'``, ``(..., 4)`` for
``impl='unsafe_rbg'`` (``QuantConfig.noise_impl``).  Every function takes
the impl from that width, as ``lbt_tpu``'s ``wrap_key`` does.

- threefry: ``fold_in(k, d)`` is the Threefry-2x32 cipher of the counter
  ``[0, d]`` under ``k``, and ``split(k, n)[i]`` is ``fold_in(k, i)``
  (JAX's partitionable split).
- unsafe_rbg: off the TPU, XLA's ``rng_bit_generator`` is Philox4x32-10
  (:func:`rbg_bits`).  ``key(seed)`` is ``[0, seed, 0, seed]``;
  ``fold_in(k, d)`` is ``k ^ r(d)``, ``r(d)`` the last of the 10 rows of
  ``rbg_bits([0, d, 0, d], 40)``; ``split(k, n)`` takes rows ``0, 10, 20,
  ...`` of ``rbg_bits(k, 40 n)``.  ``r(d)`` does not depend on ``k``, so
  the chain is an XOR: a site key is ``step_key ^ r(uid) ^ r(site)``
  (:func:`site_keys` caches that table).

Every function is vectorised over leading axes, so one step's site keys
for every layer and site come from a few numpy calls.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["base_key", "fold_in", "philox4x32_10", "rbg_bits", "site_keys",
           "split", "threefry2x32"]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# Philox4x32's multipliers and key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)
IMPLS = {2: "threefry2x32", 4: "unsafe_rbg"}


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


def philox4x32_10(key2, ctr4) -> np.ndarray:
    """The Philox4x32-10 block (Random123's) of the counter ``ctr4``
    (``(..., 4)``, low word first) under the key ``key2`` (``(..., 2)``),
    broadcast over leading axes: ``uint32 (..., 4)``."""
    key2 = np.asarray(key2, np.uint64)
    ctr4 = np.asarray(ctr4, np.uint64)
    k0, k1 = key2[..., 0], key2[..., 1]
    c0, c1, c2, c3 = (ctr4[..., i] for i in range(4))
    m0, m1 = np.uint64(PHILOX_M[0]), np.uint64(PHILOX_M[1])
    for _ in range(10):
        p0, p1 = m0 * c0, m1 * c2           # exact: 32 x 32 bits < 2**64
        c0, c1, c2, c3 = ((p1 >> _S32) ^ c1 ^ k0, p1 & _M32,
                          (p0 >> _S32) ^ c3 ^ k1, p0 & _M32)
        k0 = (k0 + np.uint64(PHILOX_W[0])) & _M32
        k1 = (k1 + np.uint64(PHILOX_W[1])) & _M32
    return np.stack(np.broadcast_arrays(c0, c1, c2, c3),
                    axis=-1).astype(np.uint32)


def rbg_bits(key4, n: int) -> np.ndarray:
    """``lax.rng_bit_generator(key4, (n,), uint32)``'s bits as XLA draws
    them off the TPU, broadcast over ``key4``'s leading axes (``(..., n)``).
    The state is ``s0 = k0 | k1 << 32``, ``s1 = k2 | k3 << 32``; block
    ``b`` is the Philox4x32-10 of the 128-bit counter ``(s0 << 64 | s1) +
    b`` (low word first) under the key ``(k0, k1)``, 4 words a block, in
    order, cut to ``n``."""
    k = np.asarray(key4, np.uint64)[..., None, :]
    b = np.arange(-(-n // 4), dtype=np.uint64)
    t = k[..., 2] + b                       # < 2**33
    c1 = k[..., 3] + (t >> _S32)
    c2 = k[..., 0] + (c1 >> _S32)
    c3 = (k[..., 1] + (c2 >> _S32)) & _M32
    ctr = np.stack(np.broadcast_arrays(t & _M32, c1 & _M32, c2 & _M32, c3),
                   axis=-1)
    words = philox4x32_10(k[..., :2], ctr)
    return words.reshape(*words.shape[:-2], -1)[..., :n]


def _width(key: np.ndarray) -> int:
    if key.shape[-1] not in IMPLS:
        raise ValueError(f"key data of width {key.shape[-1]}: 2 words is "
                         f"threefry2x32, 4 unsafe_rbg")
    return key.shape[-1]


def base_key(seed: int, impl: str = "threefry2x32") -> np.ndarray:
    """Raw data of ``jax.random.key(seed, impl=impl)`` for ``0 <= seed <
    2**31``: ``[0, seed]`` (threefry2x32) or ``[0, seed, 0, seed]``
    (unsafe_rbg)."""
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    if impl not in IMPLS.values():
        raise ValueError(f"unknown key impl {impl!r}")
    half = [0, int(seed)]
    return np.array(half * (2 if impl == "unsafe_rbg" else 1), np.uint32)


def _data(data) -> np.ndarray:
    data = np.asarray(data, np.int64)
    if (data < 0).any() or (data >= 2 ** 32).any():
        raise ValueError("fold_in data must lie in [0, 2**32)")
    return data


def _rbg_fold(data) -> np.ndarray:
    """``r(d)``: what ``fold_in`` xors into an unsafe_rbg key (the 10th
    row of ``rbg_bits([0, d, 0, d], 40)``), ``(..., 4)``."""
    d = _data(data).astype(np.uint32)
    z = np.zeros_like(d)
    return rbg_bits(np.stack([z, d, z, d], axis=-1), 40)[..., 36:40]


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in`` on raw key data.  ``key`` is ``(..., 2)`` or
    ``(..., 4)``; ``data`` (non-negative ints below 2**32) broadcasts
    against ``key[..., 0]``."""
    key = np.asarray(key, np.uint32)
    if _width(key) == 4:
        return key ^ _rbg_fold(data)
    data = _data(data)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          np.zeros(data.shape, np.uint32),
                          data.astype(np.uint32))
    return np.stack(np.broadcast_arrays(y0, y1), axis=-1)


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)`` on raw key data of one key:
    ``(n, width)``."""
    key = np.asarray(key, np.uint32)
    if _width(key) == 2:
        return fold_in(key, np.arange(n))
    return rbg_bits(key, 40 * n).reshape(n, 10, 4)[:, 0]


@functools.lru_cache(maxsize=8)
def _rbg_site_table(n_uids: int, n_sites: int) -> np.ndarray:
    """``r(uid) ^ r(site)`` for every uid and site, ``[U, S, 4]``."""
    return (_rbg_fold(np.arange(n_uids))[:, None, :]
            ^ _rbg_fold(np.arange(n_sites))[None, :, :])


def site_keys(step_key, n_uids: int, n_sites: int) -> np.ndarray:
    """``[n_uids, n_sites, width]`` table of ``fold_in(fold_in(step_key,
    uid), site)`` for every uid and site index.  Under unsafe_rbg that is
    ``step_key ^ r(uid) ^ r(site)``, from a table cached per size."""
    step_key = np.asarray(step_key, np.uint32)
    if _width(step_key) == 4:
        return step_key ^ _rbg_site_table(n_uids, n_sites)
    per_uid = fold_in(step_key, np.arange(n_uids))          # [U, 2]
    return fold_in(per_uid[:, None, :], np.arange(n_sites)[None, :])
