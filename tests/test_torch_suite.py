"""What the port's tests assume of :mod:`torch_suite`: the one intra-op
thread it pins changes no result of the port, and its per-test time limit
fails a test past it by name while the next test still runs."""
import os
import signal

import numpy as np
import torch
import torch_suite

from lbt_tpu_torch.config import QuantConfig, TrainConfig
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.train.optim import momentum_init
from lbt_tpu_torch.train.step import make_train_step

pytest_plugins = ["torch_suite", "pytester"]


def _resnet8_step():
    """One ResNet-8 train step under uniform(8, noise_mode='hash'),
    batch 4: its outputs, parameters, buffers and velocity."""
    cfg = QuantConfig.uniform(8, noise_mode="hash")
    model = cifar10_resnet(cfg, 8).init(torch.Generator().manual_seed(0))
    vel = momentum_init(dict(model.net.named_parameters()))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32))
    out = make_train_step(model, TrainConfig())(
        model, vel, x, torch.tensor([1, 2, 3, 4]), 0, 0.05,
        keys.base_key(0))
    return {**{f"out.{k}": v for k, v in out.items()},
            **{f"param.{k}": p.detach() for k, p in
               model.net.named_parameters()},
            **{f"buffer.{k}": b for k, b in model.net.named_buffers()},
            **{f"velocity.{k}": v for k, v in vel.items()}}


def test_train_step_is_the_same_at_any_thread_count():
    """The suite runs one intra-op thread; a user on the CPU runs one per
    CPU.  A train step gives the same bits at both."""
    one = _resnet8_step()
    with torch_suite.threads(max(2, os.cpu_count() or 1)):
        many = _resnet8_step()
    assert torch.get_num_threads() == 1
    assert one.keys() == many.keys()
    for k in one:
        assert torch.equal(one[k], many[k]), k


def test_a_test_past_its_limit_fails_by_name_and_the_next_runs(
        pytester, monkeypatch):
    pytester.makepyfile(test_hang="""
        import time

        pytest_plugins = ["torch_suite"]

        def test_hangs():
            time.sleep(30)

        def test_next():
            pass
    """)
    with monkeypatch.context() as m:
        m.setattr(torch_suite, "TIME_LIMIT_S", 0.5)
        rec = pytester.inline_run("-p", "no:cacheprovider")
    rec.assertoutcome(passed=1, failed=1)
    (fail,) = rec.getfailures()
    assert fail.nodeid == "test_hang.py::test_hangs"
    assert ("test_hang.py::test_hangs (call) ran past its time limit of "
            "0.5 s") in fail.longreprtext
    # this test's own limit runs on after the session inside it
    assert signal.getitimer(signal.ITIMER_REAL)[0] > 0
