"""The stochastic-rounding noise and its key chain, frozen here so that the
reference draws the very noise the configuration states.

Keys are the raw data of JAX's ``threefry2x32`` keys: ``base_key(seed) =
[0, seed]``, ``fold_in(k, d)`` the Threefry-2x32 cipher of the counter
``[0, d]`` under ``k``.  A training step's key is ``fold_in(base, step)``
and a site's ``fold_in(fold_in(step_key, uid), site)``, ``uid`` the
layer's depth-first index.  The noise of a site over the row-major flat
index ``i`` of its tensor is one of:

- ``hash1``: one multiply-xorshift round of ``i ^ seed``, ``seed =
  k[0] + k[-1] * 0x9E3779B9 mod 2**32``; ``hash`` the lowbias32 finalizer;
  the top 24 bits over 2**24;
- ``prng``: ``jax.random.uniform`` under the key with partitionable
  threefry: the cipher of ``(hi32(i), lo32(i))``, its two words xored, the
  top 23 bits as the mantissa of 1.0, minus 1.

Plain int64 torch operations masked to 32 bits (the keys in numpy).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
HASH_M1, HASH_M2 = 0x7FEB352D, 0x846CA68B


def _rotl_np(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32_np(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 numpy arrays."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(PARITY))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl_np(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def base_key(seed: int) -> np.ndarray:
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"key seed {seed} outside [0, 2**31)")
    return np.array([0, int(seed)], np.uint32)


def fold_in(key, data) -> np.ndarray:
    key = np.asarray(key, np.uint32)
    data = np.asarray(data, np.int64).astype(np.uint32)
    y0, y1 = threefry2x32_np(key[..., 0], key[..., 1],
                             np.zeros(data.shape, np.uint32), data)
    return np.stack(np.broadcast_arrays(y0, y1), axis=-1)


def site_keys(step_key, n_uids: int, n_sites: int) -> np.ndarray:
    """``[n_uids, n_sites, 2]``: ``fold_in(fold_in(step_key, uid), site)``."""
    per_uid = fold_in(np.asarray(step_key, np.uint32), np.arange(n_uids))
    return fold_in(per_uid[:, None, :], np.arange(n_sites)[None, :])


def key_seed(key) -> int:
    kd = [int(v) & M32 for v in key]
    return (kd[0] + kd[-1] * 0x9E3779B9) & M32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` below 2**32, in 16-bit halves
    of ``c`` so no product overflows int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_uniform(key, n: int, light: bool, device) -> torch.Tensor:
    """``n`` uniforms in [0, 1) (f32) of the counter hash of ``key``."""
    x = torch.arange(n, dtype=torch.int64, device=device) ^ key_seed(key)
    if not light:
        x = x ^ (x >> 16)
    x = _mul32(x, HASH_M1)
    x = x ^ (x >> 15)
    x = _mul32(x, HASH_M2)
    if not light:
        x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    t = (v << r).bitwise_and_(M32)
    return t.bitwise_or_(v >> (32 - r))


def threefry_uniform(key, n: int, device) -> torch.Tensor:
    """``n`` uniforms in [0, 1) (f32): ``jax.random.uniform(key, (n,))``."""
    k0, k1 = int(key[0]) & M32, int(key[1]) & M32
    ks = (k0, k1, (k0 ^ k1 ^ PARITY) & M32)
    c = torch.arange(n, dtype=torch.int64, device=device)
    x0 = (c >> 32).add_(ks[0]).bitwise_and_(M32)
    x1 = c.bitwise_and_(M32).add_(ks[1]).bitwise_and_(M32)
    for i in range(5):
        for r in ROT[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(mode: str, key, n: int, device) -> torch.Tensor:
    """The noise of ``mode`` (``'hash'``, ``'hash1'`` or ``'prng'``)."""
    if mode == "prng":
        return threefry_uniform(key, n, device)
    if mode in ("hash", "hash1"):
        return hash_uniform(key, n, mode == "hash1", device)
    raise ValueError(f"unknown noise mode {mode!r}")
