"""The port's Trainer and CLI under tensor parallelism on the CPU (torch
only), ResNet-8 on synthetic CIFAR-10 with augmentation, the ranks
processes of ``tests/torch_ranks.py``:

1. tp = 2 on 2 ranks (one data index: the one-rank steps on the sharded
   model) trains, evaluates and checkpoints the whole tensors; it equals
   the one-process Trainer bit for bit, a run resumed from its own
   checkpoint equals the straight run, its checkpoint restores in one
   process, and one process's checkpoint restores at tp = 2;
2. dp x tp = 2 x 2 on 4 ranks with the low-bit all-reduce equals dp 2
   (tp = 1) on 2 ranks, bit for bit: the data-parallel step, the masked
   eval and the checkpoint's ebuf on the layout;
3. ``python -m lbt_tpu_torch.main --data_parallel --tensor_parallel 2``
   under ``torch.distributed.run``, on the integer route and on the float
   route (``--engine sim_bf16``): trains, evaluates, and a second run
   resumes from its checkpoint.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch.data.datasets import load_dataset, make_augment
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.train.trainer import Trainer
from torch_ranks import WD, rank_env, start_ranks

N_TRAIN, N_TEST, BATCH = 32, 20, 8
HASH = {"noise_mode": "hash"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tc(**kw):
    return dict(batch_size=BATCH, eval_batch_size=16, log_every=1000,
                lr=0.05, checkpoint_every_epochs=1, **kw)


def _job(**kw):
    return {"kind": "trainer", "n_train": N_TRAIN, "n_test": N_TEST,
            "cfg": HASH, "augment": True, **kw}


def _one_process(tc_kw, restore_only=False):
    """The Trainer in this process (one rank, tp = 1)."""
    data = load_dataset("cifar10", n_train=N_TRAIN, n_test=N_TEST)
    cfg = tconfig.QuantConfig.uniform(8, **HASH)
    tr = Trainer(cifar10_resnet(cfg, 8, weight_decay=WD),
                 tconfig.TrainConfig(data_parallel=True, **tc_kw), data,
                 augment=make_augment("cifar10"), device="cpu")
    if restore_only:
        tr.maybe_restore()
        ev = None
    else:
        ev = tr.train()
    state = {k: {kk: vv.detach().numpy().copy() for kk, vv in t.items()}
             for k, t in tr._state().items() if isinstance(t, dict)}
    tr.metrics.close()
    return {"eval": ev, "state": state, "step": tr.step}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tptrainer")
    ck = {k: str(tmp / k) for k in ("tp2", "tp2_first", "one", "tp22",
                                    "dp2")}
    # one process's checkpoint (2 epochs), for the tp = 2 restore; one
    # intra-op thread, as each rank has
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    one = _one_process(_tc(n_epoch=2, checkpoint_dir=ck["one"]))
    tp2 = dict(tensor_parallel=2)
    lowbit = dict(lowbit_allreduce=True, n_epoch=1)
    waits = {
        "tp2": start_ranks(tmp / "r_tp2", {
            "straight": _job(train=True, tc=_tc(
                n_epoch=2, checkpoint_dir=ck["tp2"], **tp2)),
            "first": _job(train=True, tc=_tc(
                n_epoch=1, checkpoint_dir=ck["tp2_first"], **tp2)),
            "resumed": _job(train=True, tc=_tc(
                n_epoch=2, checkpoint_dir=ck["tp2_first"], **tp2)),
            "restored": _job(restore_only=True, tc=_tc(
                n_epoch=2, checkpoint_dir=ck["one"], **tp2)),
        }, 2),
        "tp22": start_ranks(tmp / "r_tp22", {"run": _job(train=True, tc=_tc(
            checkpoint_dir=ck["tp22"], **tp2, **lowbit))}, 4),
        "dp2": start_ranks(tmp / "r_dp2", {"run": _job(train=True, tc=_tc(
            checkpoint_dir=ck["dp2"], **lowbit))}, 2),
    }
    out = {k: w(timeout=300) for k, w in waits.items()}
    out["one"] = one
    out["one_restored"] = _one_process(
        _tc(n_epoch=2, checkpoint_dir=ck["tp2"]), restore_only=True)
    out["ck"] = ck
    torch.set_num_threads(threads)
    return out


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_tp2_trainer_equals_one_process(runs):
    """2 epochs at tp = 2 on 2 ranks: the whole state and the eval equal
    the one-process run's; both ranks hold it."""
    for r in (0, 1):
        got = runs["tp2"][r]["straight"]
        assert got["layout"] == (None, 2)
        assert got["step"] == runs["one"]["step"] == 8
        _equal(got["state"], runs["one"]["state"])
        assert got["eval"] == runs["one"]["eval"]


def test_tp2_resume_is_bitwise(runs):
    """1 epoch, then a second run to 2 that resumes from its checkpoint
    (the whole tensors, sliced again): the straight run's state."""
    for r in (0, 1):
        res = runs["tp2"][r]["resumed"]
        assert runs["tp2"][r]["first"]["step"] == 4 and res["step"] == 8
        _equal(res["state"], runs["tp2"][r]["straight"]["state"])
        assert res["eval"] == runs["tp2"][r]["straight"]["eval"]
    assert not runs["tp2"][1]["straight"]["saves"], "rank 0 alone saves"
    assert runs["tp2"][0]["straight"]["saves"] == [4, 8]


def test_checkpoints_restore_across_tp(runs):
    """A tp = 2 checkpoint restores in one process, and one process's at
    tp = 2, each to the state it was written from."""
    _equal(runs["one_restored"]["state"],
           runs["tp2"][0]["straight"]["state"])
    for r in (0, 1):
        _equal(runs["tp2"][r]["restored"]["state"], runs["one"]["state"])
    saved = torch.load(os.path.join(runs["ck"]["tp2"], "8", "state.pt"),
                       weights_only=True)
    w = [k for k, v in saved["model"].items() if v.shape == (3, 3, 64, 64)]
    assert w, "the sharded conv is saved whole"


def test_dp_tp_2x2_trainer_equals_dp_2(runs):
    """dp x tp = 2 x 2 with the low-bit all-reduce, 1 epoch and an eval:
    each rank holds the state of its data index's rank in dp 2, ebuf
    included, and the same eval."""
    for r in range(4):
        got, want = runs["tp22"][r]["run"], runs["dp2"][r // 2]["run"]
        assert got["layout"] == (2, 2)
        _equal(got["state"], want["state"])
        assert got["eval"] == want["eval"]
        assert math.isfinite(got["eval"]["loss"])


def _cli_tp2_resumes(tmp_path, extra):
    """``torch.distributed.run`` with 2 ranks on the CPU, ``--data_parallel
    --tensor_parallel 2`` on ResNet-20 (its 3x3x64x64 convs sharded) with
    ``extra`` flags: 1 epoch, an eval, a checkpoint; then 2 epochs resume
    from it."""
    exp = tmp_path / "exp"
    for n_epoch in (1, 2):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "lbt_tpu_torch.main",
               "--device", "cpu", "--data_parallel", "--tensor_parallel", "2",
               "--model", "CIFAR10_Resnet20", "--noise_mode", "hash",
               "--n_train", "32", "--n_test", "20", "--batch_size", "8",
               "--n_epoch", str(n_epoch), "--log_every", "1",
               "--exp_path", str(exp), *extra]
        out = subprocess.run(cmd, cwd=tmp_path, env=rank_env(),
                             capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rows = [json.loads(s) for s in
            (exp / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 8 and all(math.isfinite(v) for v in losses)
    assert sum("test/loss" in r for r in rows) == 2
    log = (exp / "experiment.log").read_text()
    assert log.count("Start of experiment") == 2
    assert "column slices" in log and "Resumed from" in log
    assert sorted(int(d) for d in os.listdir(exp / "ckpt")) == [4, 8]
    return log


def test_cli_trains_tensor_parallel_under_torchrun(tmp_path):
    """The integer route (``main.py``'s default engine, int8)."""
    _cli_tp2_resumes(tmp_path, [])


def test_cli_trains_float_route_tensor_parallel_under_torchrun(tmp_path):
    """The float route: ``--engine sim_bf16`` (the bench's baseline
    engine), its sharded convs contracted in bf16 and their partial dx
    summed over the model group."""
    log = _cli_tp2_resumes(tmp_path, ["--engine", "sim_bf16"])
    assert '"engine": "sim_bf16"' in log
