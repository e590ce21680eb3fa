"""The harness's plumbing on the CPU at the tiny twins, with the kernels'
plain versions: discovery by name, a whole run (set-up, window, traced
sub-window, the reference, ``correct``), the result line's format, the
import check, and ``correct`` false under each fault a training cell can
have.  No device metric of these runs is printed."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from conftest import CELLS, ROOT, bench

from portbench import harness

FIELDS = ["correct", "attempted", "failed", "metrics", "device"]


def _cell(twin, workload, b=None):
    return harness.Cell(b or bench(), workload, here=twin)


def test_a_new_config_mix_and_metric_take_only_new_files(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new entries of ``BENCHMARK.json`` run with no other edit."""
    from conftest import twin_dir
    here = twin_dir(tmp_path)
    cfg = json.loads((here / "configs/resnet50-dfxp8-int8.json").read_text())
    cfg["quant"]["noise_mode"] = "hash"
    (here / "configs/resnet50-dfxp8-int8-hash.json").write_text(
        json.dumps(cfg))
    mix = json.loads((here / "traffic/train.json").read_text())
    mix.update(batch_size=2, pool_batches=3, warmup_steps=3)
    (here / "traffic/train-small.json").write_text(json.dumps(mix))
    (here / "metrics/steps_per_s.train.py").write_text(
        "UNIT = '1/s'\n\n\ndef read(rec):\n"
        "    w = rec['window']\n    return w['steps'] / w['seconds']\n")
    (here / "limits/new-cell.json").write_text(
        (here / "limits/r50-int8-train-b256.json").read_text())
    b = bench()
    b["configs"].append({"name": "resnet50-dfxp8-int8-hash",
                         "source": "https://arxiv.org/abs/1512.03385",
                         "file": "portbench/configs/"
                                 "resnet50-dfxp8-int8-hash.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "new-cell",
                           "config": "resnet50-dfxp8-int8-hash",
                           "traffic": "train-small", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "steps_per_s.train", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "trainer", "moves": "train_img_s",
                           "workloads": ["new-cell"]})
    cell = harness.Cell(b, "new-cell", here=here)
    assert cell.mix["batch_size"] == 2
    res = harness.run_cell(cell, 3, 0.5, True, "cpu", time.perf_counter())
    line = harness.result_line(cell, res, True, "cpu", 1)
    assert res["correct"], res["numbers"]
    assert line["metrics"]["steps_per_s.train"]["unit"] == "1/s"
    assert line["metrics"]["steps_per_s.train"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_and_its_lines(twin, workload):
    """A traced and an untraced run of the twin: ``correct``, the result
    line's keys in order with the compared numbers last, each beside its
    limit, and the trace run's per-layer metrics (none from the device on
    the CPU)."""
    cell = _cell(twin, workload)
    for trace in (False, True):
        res = harness.run_cell(cell, 2 ** 31 + 5, 0.5, trace, "cpu",
                               time.perf_counter())
        assert res["correct"], res["numbers"]
        line = harness.result_line(cell, res, trace, "cpu", 1)
        keys = list(line)
        assert keys[:5] == FIELDS and keys[-1] == "checks"
        assert set(line["checks"]) == set(cell.limits["limits"])
        for k, v in line["checks"].items():
            assert v["value"] <= v["limit"]
        json.loads(json.dumps(line))
        names = set(line["metrics"])
        if trace:
            assert names == {"input_stall_pct.train", "mfu.train"}
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert names == {"setup_s", "train_img_s", "train_peak_gib"}
        assert res["attempted"] == res["window"]["steps"] > 0
        lines = harness.check.lines(res["numbers"], res["limits"])
        assert [s.split(":")[0] for s in lines] == [
            f"check {k}" for k in cell.limits["limits"]]


def _no_update(monkeypatch):
    """A step that returns its state unchanged: the SGD update skipped."""
    from lbt_tpu_torch.train import step
    monkeypatch.setattr(step, "sgd_update", lambda *a, **kw: None)
    return None


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    def plant(prog):
        inner = prog.trainer.train_step

        def half(model, velocity, x, y, *rest):
            n = x.shape[0] // 2
            return inner(model, velocity, x[:n], y[:n], *rest)

        prog.trainer.train_step = half
    return plant


@pytest.mark.parametrize("fault", [_no_update, _half_batch])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(twin, workload, fault, monkeypatch):
    """With the timed path broken underneath, ``correct`` comes out
    false."""
    res = harness.run_cell(_cell(twin, workload), 17, 0.2, False, "cpu",
                           time.perf_counter(), faults=fault(monkeypatch))
    assert not res["correct"], res["numbers"]


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    """``jax.numpy`` and ``lbt_tpu.x`` are caught, ``lbt_tpu_torch`` and
    ``jaxtyping`` are not."""
    import types
    before = set(harness.forbidden_modules())
    for name in ("lbt_tpu_torch", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "lbt_tpu.x", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert {"jax", "lbt_tpu"} <= set(harness.forbidden_modules())


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints nothing on
    standard output; so it does from a directory holding only
    ``BENCHMARK.json`` and ``portbench/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", CELLS[0],
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and out.stdout == ""
