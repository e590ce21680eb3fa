"""Streaming ImageFolder pipeline (PyTorch port of
``lbt_tpu/data/imagefolder.py``): ImageNet-class data in directory trees

    root/<class_name>/<image>.{jpeg,jpg,png,bmp}

decoded (PIL) and transformed by a host thread pool and yielded as ready
normalized float32 NHWC batches, so the dataset never has to fit in
memory.  ``data.pipeline.device_prefetch`` overlaps the decode with the
device step; the Trainer takes the resulting dict directly.

Transforms (torchvision's choices for ImageNet):
* train: RandomResizedCrop(image_size, scale=(0.08, 1.0),
  ratio=(3/4, 4/3)) and a random horizontal flip;
* eval: resize the shortest side to ``image_size * 256 // 224``, then a
  center crop.

Normalization: ``x / 127.5 - 1``, roughly [-1, 1].  Every random decision
derives from (seed, epoch, position), so a given (seed, epoch) replays
exactly, and gives ``lbt_tpu``'s batches bit for bit.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_EXTS = (".jpeg", ".jpg", ".png", ".bmp")


def _scan(root: str) -> Tuple[List[str], np.ndarray, List[str]]:
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise ValueError(f"no class directories under {root!r}")
    paths: List[str] = []
    labels: List[int] = []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(_EXTS):
                paths.append(os.path.join(cdir, fn))
                labels.append(ci)
    if not paths:
        raise ValueError(f"no images under {root!r}")
    return paths, np.asarray(labels, np.int32), classes


def _random_resized_crop_box(rng: np.random.Generator, w: int, h: int,
                             scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop's box sampler (10 tries then
    center fallback)."""
    area = w * h
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = float(np.exp(rng.uniform(*log_ratio)))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return x0, y0, cw, ch
    # fallback: biggest center crop within the ratio bounds
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


class ImageFolderDataset:
    """Directory-tree dataset with per-epoch deterministic streaming."""

    def __init__(self, root: str, image_size: int = 224,
                 train: bool = True, seed: int = 0, workers: int = 8):
        from PIL import Image  # noqa: F401  (import check at init)
        self.root = root
        self.image_size = int(image_size)
        self.train = bool(train)
        self.seed = int(seed)
        self.workers = int(workers)
        self.paths, self.labels, self.classes = _scan(root)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    # -- single-image load+transform ----------------------------------------
    def _load(self, idx: int, epoch: int) -> np.ndarray:
        from PIL import Image
        s = self.image_size
        with Image.open(self.paths[idx]) as im:
            im = im.convert("RGB")
            if self.train:
                rng = np.random.default_rng(
                    (self.seed * 1_000_003 + epoch) * 2_000_003 + idx)
                x0, y0, cw, ch = _random_resized_crop_box(
                    rng, im.width, im.height)
                im = im.resize((s, s), Image.BILINEAR,
                               box=(x0, y0, x0 + cw, y0 + ch))
                arr = np.asarray(im, np.uint8)
                if rng.random() < 0.5:
                    arr = arr[:, ::-1]
            else:
                short = s * 256 // 224
                scale = short / min(im.width, im.height)
                im = im.resize((max(s, int(round(im.width * scale))),
                                max(s, int(round(im.height * scale)))),
                               Image.BILINEAR)
                x0 = (im.width - s) // 2
                y0 = (im.height - s) // 2
                im = im.crop((x0, y0, x0 + s, y0 + s))
                arr = np.asarray(im, np.uint8)
        return arr

    # -- epoch iterator ------------------------------------------------------
    def batches(self, epoch: int, batch_size: int,
                drop_remainder: Optional[bool] = None,
                rows: Optional[Tuple[int, int]] = None,
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x f32 [B,S,S,3] in ~[-1,1], y int32 [B]) batches.

        Train: per-epoch shuffle (seeded), drop_remainder (static shapes
        for jit).  Eval: source order, remainder kept.  ``rows = (start,
        size)`` decodes and yields only those rows of each batch (a
        data-parallel rank's; fewer, or none, in a ragged last batch).
        """
        if drop_remainder is None:
            drop_remainder = self.train
        order = np.arange(len(self.paths))
        if self.train:
            np.random.default_rng(
                self.seed * 7_777_777 + epoch).shuffle(order)
        with cf.ThreadPoolExecutor(self.workers) as pool:
            for lo in range(0, len(order), batch_size):
                idxs = order[lo:lo + batch_size]
                if drop_remainder and len(idxs) < batch_size:
                    return
                if rows is not None:
                    idxs = idxs[rows[0]:rows[0] + rows[1]]
                imgs = list(pool.map(
                    lambda i: self._load(int(i), epoch), idxs))
                s = self.image_size
                x = (np.stack(imgs).astype(np.float32) / 127.5 - 1.0
                     if imgs else np.zeros((0, s, s, 3), np.float32))
                yield x, self.labels[idxs]


def streaming_dataset(train_dir: str, val_dir: Optional[str] = None,
                      image_size: int = 224, seed: int = 0,
                      workers: int = 8) -> Dict:
    """Trainer-ready dict for directory-tree data.

    ``train_iter(epoch, batch_size)`` / ``test_iter(batch_size)`` stream
    decoded batches; the Trainer uses these instead of in-memory
    ``train``/``test`` arrays when present.
    """
    tr = ImageFolderDataset(train_dir, image_size, train=True, seed=seed,
                            workers=workers)
    ev = (ImageFolderDataset(val_dir, image_size, train=False, seed=seed,
                             workers=workers)
          if val_dir else None)

    def train_iter(epoch: int, batch_size: int, rows=None):
        return tr.batches(epoch, batch_size, rows=rows)

    def test_iter(batch_size: int, rows=None):
        if ev is None:
            return iter(())
        return ev.batches(0, batch_size, rows=rows)

    return {
        "train_iter": train_iter,
        "test_iter": test_iter,
        "n_train": len(tr),
        "n_test": len(ev) if ev else 0,
        "num_classes": tr.num_classes,
        "classes": tr.classes,
        "input_shape": (image_size, image_size, 3),
        "synthetic": False,
    }
