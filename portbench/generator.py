"""The one traffic generator: reads a mix's data file
(``portbench/traffic/<mix>.json``) and makes its inputs from the seed.

``"loop": "closed_train"`` is a training job: one client that sends the
next batch when the step before has been dispatched.  Its batches cycle a
pool of ``pool_batches`` host batches of ``batch_size`` images (f32 NHWC,
standard normal, at the configuration's image size) and labels (uniform
over its classes), drawn on the device from the seed in one call each and
kept in host memory, as a dataset in RAM.  The first ``compare_steps``
(the cell's limits file) take batches 0, 1, 2 ...: rows that all differ.
"""

from __future__ import annotations

import itertools
import json
import time
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

Batch = Tuple[np.ndarray, np.ndarray]
LOOPS = ("closed_train",)


def load(path: Path) -> Dict:
    mix = json.loads(path.read_text())
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"{path}: loop {mix.get('loop')!r}, have {LOOPS}")
    return mix


def pool(mix: Dict, image_size: int, num_classes: int, seed: int,
         device) -> List[Batch]:
    """The host batches of ``mix`` from ``seed`` (drawn on ``device``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = mix["batch_size"]
    out = []
    for _ in range(mix["pool_batches"]):
        x = torch.randn((b, image_size, image_size, 3), generator=gen,
                        device=device, dtype=torch.float32)
        y = torch.randint(0, num_classes, (b,), generator=gen, device=device,
                          dtype=torch.int64)
        out.append((x.cpu().numpy(), y.cpu().numpy()))
    return out


def first(batches: List[Batch], n: int, start: int = 0) -> Iterator[Batch]:
    """``n`` batches of the pool in order from ``start``."""
    return (batches[(start + i) % len(batches)] for i in range(n))


def timed(batches: List[Batch], seconds: float) -> Iterator[Batch]:
    """The pool in a cycle until ``seconds`` have passed since the first
    batch was taken."""
    t0 = None
    for x in itertools.cycle(batches):
        if t0 is None:
            t0 = time.perf_counter()
        elif time.perf_counter() - t0 >= seconds:
            return
        yield x


def profile_steps(mix: Dict, cadence: int) -> int:
    """Steps of the traced sub-window: whole periods of the controllers'
    cadence, at least ``profile_min_steps``."""
    return max(mix["profile_periods"] * cadence, mix["profile_min_steps"])
