"""``torch.profiler`` traces of a window of training steps (PyTorch port of
``lbt_tpu/utils/profiling.py``):

    python -m lbt_tpu_torch.main ... --profile_steps 20   # steps 5..25
    # <exp_path>/profile/trace.json, a Chrome trace (chrome://tracing,
    # Perfetto)

The train step (``train/step.py``, ``parallel/dp.py``) marks its phases in
whatever profile is recording with :func:`span`: ``lbt/step`` around each
step, and inside it ``lbt/forward``, ``lbt/backward`` and ``lbt/update``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile


# the first traced step: the steps before it warm up (kernel builds,
# allocator growth)
START_STEP = 5


def span(name: str):
    """A context manager that records the block as a host operation named
    ``name`` in the ``torch.profiler`` profile that is recording, if any.

    The range is a ``cpu_op`` on the calling thread (not a user
    annotation, which the profiler would mirror onto the device's
    timeline), so a device trace holds the same events with or without
    it.  With no profile recording it costs an idle ``RecordFunction``,
    under a microsecond."""
    return _RecordFunctionFast(name)


class StepProfiler:
    """Traces the steps ``[START_STEP, START_STEP + steps)``: host ops
    and, where a CUDA device is present, its kernels.

    In ``trace.json`` each step's ranges lie on the host thread that ran
    it: ``lbt/step`` around the whole train step, and inside it
    ``lbt/forward`` (the model and the loss), ``lbt/backward`` (the
    ``.backward()`` call, whose kernels the autograd engine's own thread
    launches meanwhile) and ``lbt/update`` (the commit of the staged
    state, ``absorb_sinks`` and the SGD update).  An idle stretch on the
    GPU row falls in the phase whose range spans it on the host row."""

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
