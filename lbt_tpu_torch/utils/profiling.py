"""``torch.profiler`` traces of a window of training steps (PyTorch port of
``lbt_tpu/utils/profiling.py``):

    python -m lbt_tpu_torch.main ... --profile_steps 20   # steps 5..25
    # <exp_path>/profile/trace.json, a Chrome trace (chrome://tracing,
    # Perfetto)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile


# the first traced step: the steps before it warm up (kernel builds,
# allocator growth)
START_STEP = 5


class StepProfiler:
    """Traces the steps ``[START_STEP, START_STEP + steps)``: host ops
    and, where a CUDA device is present, its kernels."""

    def __init__(self, logdir: Optional[str], steps: int = 0):
        self.logdir = logdir
        self.steps = steps
        self.start = START_STEP
        self._prof = None
        self._done = steps <= 0 or not logdir

    def observe(self, step: int) -> None:
        if self._done:
            return
        if self._prof is None and step >= self.start:
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and step >= self.start + self.steps:
            self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.logdir, "trace.json"))
            self._prof = None
            self._done = True
