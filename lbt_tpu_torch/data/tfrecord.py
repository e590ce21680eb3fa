"""TFRecord ingestion (PyTorch port of ``lbt_tpu/data/tfrecord.py``): the
ctypes binding of the native pipeline (``native/tfrecord.cc``) and a
pure-Python writer.

Shards of length-prefixed, CRC32C-framed ``tf.Example`` records stream
through a C++ producer (record framing -> minimal protobuf walk -> libjpeg
decode -> RandomResizedCrop and flip for train, resize and center crop for
eval -> normalized f32 NHWC batches) that overlaps decode with the device
step, off the interpreter lock.  The library is built at first use
(``data.build``, with libjpeg); a failed build raises.

The writer emits standard frames readable by any TFRecord consumer, so
corpora and tests need no TensorFlow.  Feature schema (ImageNet
convention): ``image/encoded`` (JPEG bytes, or raw uint8 HWC with
``image/height`` / ``image/width``), ``image/class/label`` (int64).

Determinism: shard order, shuffle-buffer eviction and every crop and flip
derive from (seed, epoch, position) counters, so a given (seed, epoch)
replays exactly, and gives ``lbt_tpu``'s batches bit for bit.
"""

from __future__ import annotations

import ctypes
import glob as _glob
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from lbt_tpu_torch.data.build import tfrecord_library
# the event files' CRC32C and varint: the same framing
from lbt_tpu_torch.utils.tb import crc32c, masked_crc, varint  # noqa: F401


# ---------------------------------------------------------------------------
# TFRecord framing (pure Python, for the writer)
# ---------------------------------------------------------------------------


def _len_field(field: int, payload: bytes) -> bytes:
    return varint((field << 3) | 2) + varint(len(payload)) + payload


def _int64_feature(v: int) -> bytes:
    int64_list = varint((1 << 3) | 0) + varint(v)
    return _len_field(3, int64_list)


def _bytes_feature(v: bytes) -> bytes:
    return _len_field(1, _len_field(1, v))


def make_example(image: bytes, label: int, height: Optional[int] = None,
                 width: Optional[int] = None,
                 image_key: str = "image/encoded",
                 label_key: str = "image/class/label") -> bytes:
    """Serialize one tf.Example (minimal wire-format, no TF needed)."""
    entries = [
        (image_key, _bytes_feature(image)),
        (label_key, _int64_feature(int(label))),
    ]
    if height is not None:
        entries.append(("image/height", _int64_feature(int(height))))
    if width is not None:
        entries.append(("image/width", _int64_feature(int(width))))
    features = b"".join(
        _len_field(1, _len_field(1, k.encode()) + _len_field(2, f))
        for k, f in entries
    )
    return _len_field(1, features)


class TFRecordWriter:
    """Minimal TFRecord shard writer (standard framing)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        hdr = struct.pack("<Q", len(record))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", masked_crc(hdr)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str) -> Iterator[bytes]:
    """Pure-Python record iterator (verifies CRCs) — the reference
    implementation the native reader is tested against."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                return
            (length,) = struct.unpack("<Q", hdr[:8])
            (lcrc,) = struct.unpack("<I", hdr[8:12])
            if masked_crc(hdr[:8]) != lcrc:
                raise ValueError(f"bad length CRC in {path!r}")
            data = f.read(length)
            tail = f.read(4)
            if len(data) < length or len(tail) < 4:
                return
            (dcrc,) = struct.unpack("<I", tail)
            if masked_crc(data) != dcrc:
                raise ValueError(f"bad data CRC in {path!r}")
            yield data


# ---------------------------------------------------------------------------
# dataset over shards (native pipeline)
# ---------------------------------------------------------------------------


class TFRecordDataset:
    """Shard-backed dataset with the ImageFolderDataset iteration API."""

    def __init__(self, pattern, image_size: int = 224, train: bool = True,
                 seed: int = 0, workers: int = 0,
                 shuffle_buffer: int = 1024,
                 image_key: str = "image/encoded",
                 label_key: str = "image/class/label",
                 check_crc: bool = True,
                 num_classes: Optional[int] = None):
        if isinstance(pattern, str):
            self.paths = sorted(_glob.glob(pattern))
        else:
            self.paths = [str(p) for p in pattern]
        if not self.paths:
            raise ValueError(f"no TFRecord shards match {pattern!r}")
        self._lib = tfrecord_library()
        self.image_size = int(image_size)
        self.train = bool(train)
        self.seed = int(seed)
        self.workers = int(workers)
        self.shuffle_buffer = int(shuffle_buffer)
        self.image_key = image_key
        self.label_key = label_key
        self.check_crc = bool(check_crc)
        self.num_classes = num_classes
        self._n: Optional[int] = None
        self._handle = None
        self._handle_batch = None

    def _c_paths(self):
        arr = (ctypes.c_char_p * len(self.paths))()
        arr[:] = [p.encode() for p in self.paths]
        return arr

    def __len__(self) -> int:
        if self._n is None:
            self._n = int(self._lib.lbt_tfr_count(
                self._c_paths(), len(self.paths), int(self.check_crc)))
        return self._n

    def close(self) -> None:
        if self._handle is not None:
            self._lib.lbt_tfr_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if hasattr(self, "_handle"):
            self.close()

    def skipped(self) -> int:
        """Records dropped as malformed/undecodable so far."""
        if self._handle is None:
            return 0
        return int(self._lib.lbt_tfr_skipped(self._handle))

    def batches(self, epoch: int, batch_size: int,
                drop_remainder: Optional[bool] = None,
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x f32 [B,S,S,3] in ~[-1,1], y int32 [B]) batches.

        Train: shard-order + buffer shuffle (seeded), drop_remainder.
        Eval: shard order, remainder kept.  (drop_remainder is decided
        natively by the train flag; the argument is accepted for API
        parity with ImageFolderDataset.)
        """
        del drop_remainder  # native side: train drops, eval keeps
        if self._handle is not None and self._handle_batch != batch_size:
            self.close()
        if self._handle is None:
            self._handle = self._lib.lbt_tfr_create(
                self._c_paths(), len(self.paths), int(batch_size),
                self.image_size, int(self.train),
                ctypes.c_uint64(self.seed), self.workers,
                self.shuffle_buffer, self.image_key.encode(),
                self.label_key.encode(), int(self.check_crc))
            self._handle_batch = batch_size
        s = self.image_size
        x = np.empty((batch_size, s, s, 3), np.float32)
        y = np.empty((batch_size,), np.int32)
        self._lib.lbt_tfr_start_epoch(self._handle, int(epoch))
        while True:
            cnt = self._lib.lbt_tfr_next(
                self._handle,
                x.ctypes.data_as(ctypes.c_void_p),
                y.ctypes.data_as(ctypes.c_void_p))
            if cnt <= 0:
                return
            yield x[:cnt].copy(), y[:cnt].copy()


def _rows_of(batches, rows):
    if rows is None:
        return batches
    return ((x[rows[0]:rows[0] + rows[1]], y[rows[0]:rows[0] + rows[1]])
            for x, y in batches)


def tfrecord_dataset(train_pattern, val_pattern=None, image_size: int = 224,
                     seed: int = 0, workers: int = 0,
                     shuffle_buffer: int = 1024,
                     num_classes: Optional[int] = None, **kw) -> Dict:
    """Trainer-ready dict for TFRecord shards (same contract as
    ``data.imagefolder.streaming_dataset``)."""
    tr = TFRecordDataset(train_pattern, image_size, train=True, seed=seed,
                         workers=workers, shuffle_buffer=shuffle_buffer,
                         num_classes=num_classes, **kw)
    ev = (TFRecordDataset(val_pattern, image_size, train=False, seed=seed,
                          workers=workers, num_classes=num_classes, **kw)
          if val_pattern else None)

    # rows = (start, size): a data-parallel rank's rows of each batch.  The
    # C++ pipeline (native/tfrecord.cc, shared with lbt_tpu) decodes whole
    # batches, so every rank decodes the global batch and keeps its rows
    def train_iter(epoch: int, batch_size: int, rows=None):
        return _rows_of(tr.batches(epoch, batch_size), rows)

    def test_iter(batch_size: int, rows=None):
        if ev is None:
            return iter(())
        return _rows_of(ev.batches(0, batch_size), rows)

    if num_classes is None:
        raise ValueError(
            "num_classes is required for TFRecord data (labels are not "
            "enumerable without a full scan)")
    return {
        "train_iter": train_iter,
        "test_iter": test_iter,
        "n_train": len(tr),
        "n_test": len(ev) if ev else 0,
        "num_classes": num_classes,
        "input_shape": (image_size, image_size, 3),
        "synthetic": False,
    }
