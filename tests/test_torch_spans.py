"""The train step's profiler ranges (``utils.profiling.span``) on the CPU,
LeNet (``MNIST``) at batch 2: each step records one ``lbt/step`` with
``lbt/forward``, ``lbt/backward`` and ``lbt/update`` inside it, in that
order, as host operations and not as user annotations (which the profiler
mirrors onto the device's timeline); with no profiler running the ranges
change no bit of the step."""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import lbt_tpu_torch
from lbt_tpu_torch.config import QuantConfig, TrainConfig
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.models import build_model
from lbt_tpu_torch.parallel import dp as dp_mod
from lbt_tpu_torch.train import step as step_mod
from lbt_tpu_torch.train.optim import momentum_init

NAMES = {"lbt/step", "lbt/forward", "lbt/backward", "lbt/update"}
PACKAGE = Path(lbt_tpu_torch.__file__).parent


def _model():
    return build_model("MNIST", QuantConfig.uniform(8, noise_mode="hash")
                       ).init(torch.Generator().manual_seed(0))


def _batches(k):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (k, 2, 28, 28, 1)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(rng.integers(0, 10, (k, 2)))


def _profiled(fn):
    """``fn()`` under a CPU profile: the ``lbt/`` events, in order of
    start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("lbt/")),
                  key=lambda e: (e.start_ns(), -e.duration_ns()))


def _iv(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


def _check_step(events):
    """One step's events: one ``lbt/step`` holding the phases, the forward
    before the backward before every update."""
    names = [e.name() for e in events]
    assert names.count("lbt/step") == 1 and set(names) == NAMES
    (s0, s1), = [_iv(e) for e in events if e.name() == "lbt/step"]
    phases = [_iv(e) for e in events if e.name() != "lbt/step"]
    assert all(s0 <= a <= b <= s1 for a, b in phases)
    fwd, = [_iv(e) for e in events if e.name() == "lbt/forward"]
    bwd, = [_iv(e) for e in events if e.name() == "lbt/backward"]
    upd = [_iv(e) for e in events if e.name() == "lbt/update"]
    assert fwd[1] <= bwd[0] and upd and all(bwd[1] <= u[0] for u in upd)


def _run_step(model=None):
    model = model or _model()
    xs, ys = _batches(1)
    step = step_mod.make_train_step(model, TrainConfig())
    vel = momentum_init(dict(model.net.named_parameters()))
    out = step(model, vel, xs[0], ys[0], 3, 0.01, keys.base_key(7))
    return model, out


def test_one_step_records_its_phases_inside_one_step_range():
    _check_step(_profiled(_run_step))


def test_a_two_step_block_records_two_step_ranges():
    model = _model()
    xs, ys = _batches(2)
    scan = step_mod.make_scan_train_step(model, TrainConfig(), 2)
    vel = momentum_init(dict(model.net.named_parameters()))
    events = _profiled(lambda: scan(model, vel, xs, ys, 3, 0.01,
                                    keys.base_key(7)))
    steps = [_iv(e) for e in events if e.name() == "lbt/step"]
    assert len(steps) == 2 and steps[0][1] <= steps[1][0]
    for s0, s1 in steps:
        _check_step([e for e in events if s0 <= _iv(e)[0] <= s1])


def test_the_data_parallel_step_records_its_phases(tmp_path):
    """At world size 1 over gloo; the collectives lie outside the phase
    ranges."""
    from lbt_tpu_torch.parallel import Group
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            world_size=1, rank=0)
    try:
        model = _model()
        xs, ys = _batches(1)
        step = dp_mod.make_dp_train_step(model, TrainConfig(), Group())
        vel = momentum_init(dict(model.net.named_parameters()))
        events = _profiled(lambda: step(model, vel, {}, xs[0], ys[0], 3,
                                        0.01, keys.base_key(7)))
    finally:
        dist.destroy_process_group()
    _check_step(events)


def test_ranges_are_host_operations_not_user_annotations():
    events = _profiled(_run_step)
    assert events and not any(e.is_user_annotation() for e in events)
    assert all(e.device_type() == torch.autograd.DeviceType.CPU
               for e in events)


@pytest.mark.parametrize("make", ["step", "dp"])
def test_no_profiler_no_change(make, monkeypatch, tmp_path):
    """Without a profile, a step with the ranges returns the same loss and
    leaves the same parameters, bit for bit, as with them patched out."""
    from lbt_tpu_torch.parallel import Group

    def run():
        model = _model()
        xs, ys = _batches(1)
        vel = momentum_init(dict(model.net.named_parameters()))
        args = (xs[0], ys[0], 3, 0.01, keys.base_key(7))
        if make == "step":
            out = step_mod.make_train_step(model, TrainConfig())(
                model, vel, *args)
        else:
            out = dp_mod.make_dp_train_step(model, TrainConfig(), Group())(
                model, vel, {}, *args)
        return out["loss"], dict(model.net.state_dict())

    if make == "dp":
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                world_size=1, rank=0)
    try:
        loss, state = run()
        for mod in (step_mod, dp_mod):
            monkeypatch.setattr(mod, "span", contextlib.nullcontext)
        loss0, state0 = run()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert torch.equal(loss, loss0)
    assert list(state) == list(state0)
    for k in state:
        assert torch.equal(state[k], state0[k]), k


def test_the_program_has_four_range_names_and_no_record_function():
    sources = {p: p.read_text() for p in PACKAGE.rglob("*.py")}
    assert not [p for p, s in sources.items() if "record_function" in s]
    found = {n for s in sources.values()
             for n in re.findall(r'\bspan\("([^"]*)"\)', s)}
    assert found == NAMES
