"""ctypes binding for the C++ in-memory loader (``native/loader.cc``;
PyTorch port of ``lbt_tpu/data/native.py``): shuffled, augmented batches
of in-memory NHWC arrays, produced by an OpenMP-parallel thread one batch
ahead, off the interpreter lock.  The library is built at first use
(``data.build``); a failed build raises."""

from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import numpy as np

from lbt_tpu_torch.data.build import loader_library


class NativeLoader:
    """Shuffled, augmented, drop-remainder batches produced by the C++
    pipeline (one batch of lookahead, OpenMP inner parallelism).  The same
    ``(seed, epoch)`` gives ``lbt_tpu``'s batches bit for bit."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, *, pad: int = 0, flip: bool = False,
                 seed: int = 0, n_threads: int = 0):
        if images.ndim != 4:
            raise ValueError(f"images must be NHWC, got shape {images.shape}")
        if len(labels) != len(images):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self._lib = loader_library()
        # C-contiguous f32 / i32 copies, kept alive for the C side
        self._x = np.ascontiguousarray(images, np.float32)
        self._y = np.ascontiguousarray(labels, np.int32)
        n, h, w, c = self._x.shape
        self._out_x = np.empty((batch_size, h, w, c), np.float32)
        self._out_y = np.empty((batch_size,), np.int32)
        self._handle = self._lib.lbt_loader_create(
            self._x.ctypes.data_as(ctypes.c_void_p),
            self._y.ctypes.data_as(ctypes.c_void_p),
            n, h, w, c, batch_size, pad, int(flip),
            ctypes.c_uint64(seed), n_threads,
        )

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        self._lib.lbt_loader_start_epoch(self._handle, epoch)
        while True:
            cnt = self._lib.lbt_loader_next(
                self._handle,
                self._out_x.ctypes.data_as(ctypes.c_void_p),
                self._out_y.ctypes.data_as(ctypes.c_void_p),
            )
            if cnt == 0:
                return
            # copies: the output buffers are reused for the next batch
            yield self._out_x.copy(), self._out_y.copy()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.lbt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
