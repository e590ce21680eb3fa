"""The host's blocking waits on the device a train step: CUDA runtime
calls that return only once the device has caught up, whose interval lies
inside one of the program's ``lbt/step`` ranges (``train/step.py``,
``parallel/dp.py``), over the number of those ranges.  A call counts by
its time, whichever thread made it: the backward's run on autograd's
engine thread inside the caller's range.  Waits outside every step (the
harness's at the sub-window's edges, the Trainer's at an epoch's end) do
not count.

The names (:data:`SYNCS`) are the runtime's blocking calls:
``cudaStreamSynchronize`` (PyTorch's copy between host and device with
``non_blocking=False``, ``.item()``, ``.cpu()``), ``cudaDeviceSynchronize``
(``torch.cuda.synchronize``), ``cudaEventSynchronize`` and the
synchronous ``cudaMemcpy``.  An H100's trace of both cells (torch 2.11,
CUDA 12.8) holds the first two under these names: every sync inside a
step was a ``cudaStreamSynchronize``, and ``cudaDeviceSynchronize`` fell
only outside the steps.  The other two did not occur; they stay as
blocking calls that a path may make.

None without an ``lbt/step`` range (a program without the ranges) or
without a device trace (a run on the CPU records no CUDA call)."""

import bisect

UNIT = "1/step"
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def read(rec):
    p = rec.get("profile")
    if not p or not p["device"]:
        return None
    steps = sorted((s, e) for s, e, n in p["host"] if n == "lbt/step")
    if not steps:
        return None
    starts = [s for s, _ in steps]
    n = 0
    for s, e, name in p["host"]:
        if name in SYNCS:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= steps[i][1]:
                n += 1
    return n / len(steps)
