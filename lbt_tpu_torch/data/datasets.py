"""Datasets and augmentation (PyTorch port of ``lbt_tpu/data/datasets.py``).

``load_dataset`` and the seeded synthetic stand-in are ``lbt_tpu``'s numpy
code, unchanged, so both packages train on identical bytes: per-pixel
train-set mean subtraction then division by 128, from a local cache
(``LBT_DATA_DIR`` or ``~/.keras/datasets`` npz files in the keras layout),
else the synthetic set (class-prototype images plus noise).

The augmentation (random horizontal flip, zero pad, random crop back to
the input size) runs in torch on the batch's device.  Its draws come only
from a key (:mod:`lbt_tpu_torch.dfxp.keys`): the Trainer passes
``fold_in(data_key, step)``, so a batch's augmentation depends on
``(seed, step)`` alone and a resumed run augments as the uninterrupted one
did.  Under a threefry key the draws are not ``jax.random``'s; under an
``unsafe_rbg`` key they are, bit for bit (:func:`augment_draws`).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import numpy as np
import torch

from lbt_tpu_torch.dfxp.keys import rbg_bits, split, threefry2x32

Arrays = Tuple[np.ndarray, np.ndarray]

_SHAPES = {
    "mnist": ((28, 28, 1), 10, 60000, 10000),
    "pi_mnist": ((784,), 10, 60000, 10000),
    "cifar10": ((32, 32, 3), 10, 50000, 10000),
    "cifar100": ((32, 32, 3), 100, 50000, 10000),
    "imagenet": ((224, 224, 3), 1000, 128116, 5000),
    "imagenet112": ((112, 112, 3), 1000, 32768, 5000),
}

_KERAS_FILES = {
    "mnist": "mnist.npz",
    "pi_mnist": "mnist.npz",
}


def _data_dirs():
    dirs = []
    if os.environ.get("LBT_DATA_DIR"):
        dirs.append(os.environ["LBT_DATA_DIR"])
    dirs.append(os.path.expanduser("~/.keras/datasets"))
    return dirs


def _load_raw(name: str):
    """Raw uint8 (X_train, y_train), (X_test, y_test) or None."""
    for d in _data_dirs():
        f = os.path.join(d, _KERAS_FILES.get(name, f"{name}.npz"))
        if os.path.exists(f):
            z = np.load(f)
            if {"x_train", "y_train", "x_test", "y_test"} <= set(z.files):
                return ((z["x_train"], z["y_train"]),
                        (z["x_test"], z["y_test"]))
    return None


def _synthetic(name: str, n_train: int, n_test: int, seed: int = 1234,
               signal: float = 1.0, n_classes: int = 0,
               label_noise: float = 0.0):
    """Learnable synthetic stand-in: each class has a smooth prototype
    image; samples are prototype + noise, quantized to uint8.  ``signal``
    scales the prototypes against the unit noise; ``label_noise`` flips
    that fraction of the train labels."""
    shape, def_classes, _, _ = _SHAPES[name]
    n_classes = n_classes or def_classes
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, (n_classes,) + shape).astype(np.float32)
    # smooth the prototypes a little so conv nets have structure to find
    if len(shape) == 3 and shape[0] >= 8:
        k = np.ones((5, 5, 1), np.float32) / 25.0
        from scipy.ndimage import convolve
        protos = np.stack([convolve(p, k, mode="wrap") for p in protos])
        protos /= protos.std() + 1e-8
    protos *= signal

    def draw(n, seed2, flip_frac=0.0):
        r = np.random.default_rng(seed2)
        y = r.integers(0, n_classes, n).astype(np.int32)
        x = protos[y] + r.normal(0.0, 1.5, (n,) + shape).astype(np.float32)
        x = np.clip((x * 32) + 128, 0, 255).astype(np.uint8)
        if flip_frac > 0.0:
            m = r.random(n) < flip_frac
            y = np.where(m, r.integers(0, n_classes, n).astype(np.int32), y)
        return x, y

    return (draw(n_train, seed + 1, label_noise),
            draw(n_test, seed + 2)), n_classes


@functools.lru_cache(maxsize=None)
def load_dataset(name: str, n_train: int = 0, n_test: int = 0,
                 flatten: bool = False, signal: float = 1.0,
                 override_classes: int = 0,
                 label_noise: float = 0.0) -> Dict[str, Arrays]:
    """``{'train': (X, y), 'test': (X, y), 'synthetic': bool,
    'num_classes': int}`` with float32 X preprocessed the reference way
    (mean-sub, /128).  ``signal`` / ``override_classes`` /
    ``label_noise`` shape the synthetic fallback only."""
    if name not in _SHAPES:
        raise ValueError(f"unknown dataset {name!r}")
    shape, n_classes, def_train, def_test = _SHAPES[name]
    n_train = n_train or def_train
    n_test = n_test or def_test

    raw = _load_raw(name)
    synthetic = raw is None
    if synthetic:
        raw, n_classes = _synthetic(
            name, n_train, n_test, signal=signal, n_classes=override_classes,
            label_noise=label_noise)
    (xtr, ytr), (xte, yte) = raw
    xtr, ytr = xtr[:n_train], ytr[:n_train]
    xte, yte = xte[:n_test], yte[:n_test]

    xtr = xtr.astype(np.float32)
    xte = xte.astype(np.float32)
    if xtr.ndim == 3:  # mnist HxW -> HxWx1
        xtr, xte = xtr[..., None], xte[..., None]
    mean = xtr.mean(axis=0)
    xtr = (xtr - mean) / 128.0
    xte = (xte - mean) / 128.0
    ytr = ytr.astype(np.int32).reshape(-1)
    yte = yte.astype(np.int32).reshape(-1)

    if name == "pi_mnist" or flatten:
        xtr = xtr.reshape(len(xtr), -1)
        xte = xte.reshape(len(xte), -1)

    return {"train": (xtr, ytr), "test": (xte, yte),
            "synthetic": synthetic, "num_classes": n_classes}


# ---------------------------------------------------------------------------
# augmentation on the batch's device
# ---------------------------------------------------------------------------

# flip + pad-crop parameters per dataset (the reference pads CIFAR by 4);
# absent = no augmentation
AUG_SPECS = {
    "cifar10": {"pad": 4, "flip": True},
    "cifar100": {"pad": 4, "flip": True},
    "imagenet": {"pad": 16, "flip": True},
    "imagenet112": {"pad": 8, "flip": True},
}


def aug_spec(dataset: str):
    return AUG_SPECS.get(dataset)


def _rbg_randint(key, n: int, span: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), 0, span)`` (int32) under an
    unsafe_rbg key: two words a value from the two halves of
    ``split(key)``, ``(hi % span * (2**32 % span) + lo % span) % span``."""
    k1, k2 = split(key)
    hi, lo = rbg_bits(k1, n), rbg_bits(k2, n)
    span = np.uint32(span)
    mult = np.uint32(2 ** 16) % span
    mult = mult * mult % span
    return (hi % span * mult + lo % span) % span


def augment_draws(key, n: int, pad: int):
    """``(flip, oh, ow)`` for ``n`` examples: a flip bit and the crop's
    row and column offsets in ``0..2*pad``.  Under a threefry key
    (``uint32[2]``) each comes from its own counter block of the cipher;
    under an unsafe_rbg key (``uint32[4]``) they are ``lbt_tpu``'s
    ``bernoulli(kf, 0.5)`` and ``randint(kh / kw, 0, 2*pad + 1)`` of
    ``kf, kh, kw = split(key, 3)``, bit for bit."""
    key = np.asarray(key, np.uint32)
    span = 2 * pad + 1
    if key.shape[-1] == 4:
        kf, kh, kw = split(key, 3)
        # uniform(kf) < 0.5: the top bit of the word is 0
        flip = 1 - (rbg_bits(kf, n) >> np.uint32(31))
        return flip, _rbg_randint(kh, n, span), _rbg_randint(kw, n, span)
    words, _ = threefry2x32(key[0], key[1], np.zeros(3 * n, np.uint32),
                            np.arange(3 * n, dtype=np.uint32))
    words = words.reshape(3, n)
    span = np.uint32(span)
    return words[0] >> np.uint32(31), words[1] % span, words[2] % span


def augment_crop_flip(key, x: torch.Tensor, pad: int,
                      rows=None) -> torch.Tensor:
    """Random horizontal flip, then zero pad by ``pad`` and a random crop
    back to ``x``'s size, of an NHWC batch on its device: one gather from
    the padded batch, its column index mirrored where the flip is on.
    ``rows = (row0, n_global)`` says ``x`` is rows ``row0..`` of a batch
    of ``n_global`` (a data-parallel rank's): they take that batch's
    draws."""
    n, h, w, _ = x.shape
    row0, n_draws = (0, n) if rows is None else rows
    draws = np.stack(augment_draws(key, n_draws, pad))[:, row0:row0 + n]
    flip, oh, ow = torch.from_numpy(draws.astype(np.int64)).to(x.device)
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    i = torch.arange(h, device=x.device)
    j = torch.arange(w, device=x.device)
    rows = oh[:, None] + i                                   # [n, h]
    # column j of the flipped image is column w-1-j of x: in the padded
    # batch, w-1+2*pad-ow-j
    cols = torch.where(flip[:, None] == 1, (w - 1 + 2 * pad - ow)[:, None] - j,
                       ow[:, None] + j)                      # [n, w]
    b = torch.arange(n, device=x.device)[:, None, None]
    return xp[b, rows[:, :, None], cols[:, None, :]]


def make_augment(dataset: str):
    """Augmentation ``(key, x) -> x`` for a dataset, or None."""
    spec = AUG_SPECS.get(dataset)
    if spec is None:
        return None
    return functools.partial(augment_crop_flip, pad=spec["pad"])
