"""The readers of the program's train-step ranges on hand-built records:
``host_syncs_per_step.train`` and ``idle_pct.{forward,backward,update}.train``
give nothing without an ``lbt/step`` range or a device trace, count only
the syncs inside a step, and split ``device_idle_pct.train`` exactly by
phase; and the twin's traced record holds the ranges they read."""

import pytest
import torch

from conftest import TWIN_BATCH, bench

from portbench import generator, harness, trace

SPANS = ("host_syncs_per_step.train", "idle_pct.forward.train",
         "idle_pct.backward.train", "idle_pct.update.train")
MS = 10 ** 6


def _read(name, rec):
    return harness.metric_reader(name).read(rec)


def _ms(*ivs):
    return [(s * MS, e * MS, n) for s, e, n in ivs]


def _record():
    """A 1-s sub-window of two steps (times in ms).  Busy: 0-40, 70-120,
    150-200, 300-400, 610-800, 850-860 (440 ms: 56% idle).  Idle by phase:
    forward 40 + 90, backward 100, update 0 + 40 + 80; outside the phases
    20 + 70 + 10 + 10 + 100."""
    host = _ms((50, 450, "lbt/step"), (60, 150, "lbt/forward"),
               (160, 350, "lbt/backward"), (355, 370, "lbt/update"),
               (380, 440, "lbt/update"),
               (500, 950, "lbt/step"), (510, 600, "lbt/forward"),
               (610, 800, "lbt/backward"), (810, 900, "lbt/update"),
               (65, 66, "aten::mul"), (200, 201, "cudaStreamSynchronize"),
               (445, 455, "cudaStreamSynchronize"),
               (620, 621, "cudaMemcpyAsync"), (630, 640, "cudaMemcpy"),
               (700, 701, "cudaEventSynchronize"),
               (700, 701, "cudaLaunchKernel"),
               (960, 990, "cudaDeviceSynchronize"))
    device = _ms((0, 40, "k"), (70, 100, "k"), (90, 120, "k"),
                 (150, 200, "k"), (300, 400, "k"), (610, 800, "k"),
                 (850, 860, "k"))
    return {"profile": {"steps": 2, "wall_s": 1.0, "host": host,
                        "device": device}}


@pytest.mark.parametrize("name", SPANS)
def test_nothing_without_a_step_range_or_a_device_trace(name):
    rec = _record()
    assert _read(name, rec) is not None
    assert _read(name, {}) is None
    without = {**rec["profile"],
               "host": [h for h in rec["profile"]["host"]
                        if h[2] != "lbt/step"]}
    assert _read(name, {"profile": without}) is None
    assert _read(name, {"profile": {**rec["profile"], "device": []}}) is None


def test_syncs_inside_a_step_count_and_the_harness_s_do_not():
    """In step 1 a stream sync; in step 2 a synchronous copy and an event
    sync; the asynchronous copy, the sync across the end of step 1 and the
    harness's device sync after the steps do not count."""
    assert _read("host_syncs_per_step.train", _record()) == 1.5


def test_the_phases_split_the_idle_share_exactly():
    rec = _record()
    got = {n: _read(f"idle_pct.{n}.train", rec)
           for n in ("forward", "backward", "update")}
    assert got == {"forward": 13.0, "backward": 10.0, "update": 12.0}
    outside = 21.0
    assert sum(got.values()) + outside == pytest.approx(
        _read("device_idle_pct.train", rec), rel=1e-12, abs=0)


def test_the_twin_s_traced_record_holds_a_step_range_a_step(twin):
    """The program's ranges reach the harness's record: one ``lbt/step`` a
    step, each holding its forward, backward and updates."""
    from portbench import program
    cell = harness.Cell(bench(), "r50-int8-train-b256", here=twin)
    pool = generator.pool({**cell.mix, "pool_batches": 2},
                          cell.spec.image_size, cell.spec.num_classes, 5,
                          torch.device("cpu"))
    prog = program.Program(cell.cfg, TWIN_BATCH, 5, 200, "cpu")
    rec = {"steps": 2}
    with trace.profiled(rec, lambda: None):
        prog.run(generator.first(pool, 2))
    host = rec["host"]
    steps = sorted((s, e) for s, e, n in host if n == "lbt/step")
    assert len(steps) == 2 and rec["wall_s"] > 0
    for s0, s1 in steps:
        inside = [n for s, e, n in host
                  if s0 <= s and e <= s1 and n.startswith("lbt/")]
        assert inside.count("lbt/forward") == inside.count(
            "lbt/backward") == 1
        assert inside.count("lbt/update") == 2
