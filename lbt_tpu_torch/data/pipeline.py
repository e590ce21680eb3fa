"""Host batching with background device prefetch (PyTorch port of
``lbt_tpu/data/pipeline.py``).

``batch_iterator`` is ``lbt_tpu``'s, unchanged: the same ``(seed, epoch)``
gives the same batches in both packages.  ``device_prefetch`` runs a
producer thread that copies each numpy batch into pinned host memory and
issues its host-to-device copy on a side CUDA stream, ``size`` batches
ahead of the consumer, so the copies overlap the train step.
"""

from __future__ import annotations

import queue as _q
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def batch_iterator(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    drop_remainder: bool = True,
    seed: int = 0,
    epoch: int = 0,
    rows: Optional[Tuple[int, int]] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled minibatches (numpy copies).  ``drop_remainder`` keeps
    every batch the same shape.  ``rows = (start, size)`` yields only
    those rows of each batch (a data-parallel rank's), gathering no
    other."""
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng((seed << 20) ^ epoch)
        rng.shuffle(idx)
    end = n - (n % batch_size) if drop_remainder else n
    for start in range(0, end, batch_size):
        sel = idx[start:start + batch_size]
        if rows is not None:
            sel = sel[rows[0]:rows[0] + rows[1]]
        yield x[sel], y[sel]


def _to_cuda(batch, device: torch.device, stream: torch.cuda.Stream):
    """Pinned copies of the batch's arrays, sent to ``device`` on
    ``stream``; returns the device tensors and an event recorded after
    the copies."""
    with torch.cuda.stream(stream):
        out = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                    .to(device, non_blocking=True) for a in batch)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def device_prefetch(iterator, size: int = 2,
                    device: Optional[torch.device] = None):
    """Yield the batches of ``iterator`` (tuples of numpy arrays) as
    tensors on ``device`` (default the CPU), ``size`` batches ahead.

    Order is preserved; an exception in the producer re-raises at the
    consumer; an abandoned generator (an exception in the train step, an
    early break) stops the producer.  On a CUDA device the consumer's
    stream waits on each batch's copy event, and each tensor is marked
    used on that stream so the allocator does not hand its memory out
    while the step still reads it.  On the CPU the arrays only become
    tensors."""
    device = torch.device(device if device is not None else "cpu")
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: "_q.Queue" = _q.Queue(maxsize=size)
    _END, _ERR = object(), object()
    stop = threading.Event()

    def _put(item) -> bool:
        # a bounded put that gives up once the consumer is gone, so an
        # abandoned generator cannot leave this thread blocked forever
        # holding device batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _q.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                item = (_to_cuda(batch, device, side) if cuda
                        else (tuple(torch.from_numpy(np.asarray(a))
                                    for a in batch), None))
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised below
            _put((_ERR, e))
            return
        _put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if item[0] is _ERR:
                raise item[1]
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for a in batch:
                    a.record_stream(stream)
            yield batch
    finally:
        # consumer done or abandoned (GeneratorExit lands here): stop the
        # producer and drain, so an in-flight put unblocks and the device
        # batches are released
        stop.set()
        try:
            while True:
                q.get_nowait()
        except _q.Empty:
            pass
