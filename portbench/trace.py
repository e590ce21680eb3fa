"""The traced sub-window: ``torch.profiler`` over a few steps, reduced to
what the per-layer metrics and the breakdown read.

The record holds the sub-window's host wall seconds and steps, every
device interval ``(start_ns, end_ns, name)`` (kernels, copies and
fills), every host operation's interval, the port's kernel calls as
recorded by their wrappers (``program.recorded_calls``) and the wrappers'
launch counters.  No trace file is written.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

# the port's own kernels by the device name of their launches
KERNELS = {"k1": ("k1_quantize_kernel",),
           "k2": ("int8_gemm_kernel", "int8_gemm_tn_kernel"),
           "fused": ("conv_fused_kernel",)}
TOP = 10


def kernel_class(name: str):
    for cls, names in KERNELS.items():
        if any(n in name for n in names):
            return cls
    return None


@contextlib.contextmanager
def profiled(rec: Dict, sync):
    """Profile the block (host and device activity) into ``rec``: its host
    wall seconds (``sync`` ends it) and the intervals."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        sync()
        rec["wall_s"] = time.perf_counter() - t0
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        iv = (s, s + e.duration_ns(), e.name())
        if e.device_type() == cuda:
            dev.append(iv)
        elif e.device_type() == cpu:
            host.append(iv)
    rec["device"], rec["host"] = dev, host


def merged(ivs: List[Tuple[int, int, str]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e, _ in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_s(rec: Dict) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in merged(rec["device"])) / 1e9


def device_ops(rec: Dict) -> List[List]:
    """The device operations that took the most time, in seconds."""
    tot = collections.Counter()
    for s, e, name in rec["device"]:
        tot[name[:200]] += (e - s) / 1e9
    return [[n, v] for n, v in tot.most_common(TOP)]


def idle_gaps(rec: Dict) -> List[List]:
    """The longest idle gaps of the device, each named by the host
    operation that overlaps it most (the shortest such, on a tie), in
    seconds."""
    iv = merged(rec["device"])
    gaps = sorted(((iv[i + 1][0] - iv[i][1], iv[i][1], iv[i + 1][0])
                   for i in range(len(iv) - 1)), reverse=True)[:TOP]
    if not rec["host"]:
        return [["(no host trace)", g / 1e9] for g, _, _ in gaps]
    hs = np.array([h[0] for h in rec["host"]], dtype=np.int64)
    he = np.array([h[1] for h in rec["host"]], dtype=np.int64)
    out = []
    for g, g0, g1 in gaps:
        over = np.minimum(he, g1) - np.maximum(hs, g0)
        best = over.max()
        if best <= 0:
            out.append(["(no host operation)", g / 1e9])
            continue
        cand = np.nonzero(over >= best)[0]
        i = cand[np.argmin((he - hs)[cand])]
        out.append([rec["host"][i][2][:200], g / 1e9])
    return out
