"""The port's data-parallel eval, Trainer and CLI held against
``lbt_tpu`` on the CPU, 2 ranks (``tests/torch_ranks.py``, gloo) against
a 2-device mesh:

4. the masked DP eval with a ragged padded last batch, with and without
   ``faithful_eval`` (the noise counter's offset at each rank's rows);
5. the Trainer on ResNet-8 and synthetic CIFAR, 1 epoch of 4 steps and an
   eval, against ``lbt_tpu``'s Trainer (without augmentation: the port's
   draws are not ``jax.random``'s, ``test_torch_data.py``); rank 0 alone
   writing logs, metrics and checkpoints; resume with augmentation,
   bitwise, and the low-bit all-reduce's ``ebuf`` restored as
   ``lbt_tpu`` restores it;
6. the CLI under ``torch.distributed.run``, with the flags refused
   before they were ported (``--remat_bn``, ``--bn_residual_q16``,
   ``--scan_steps``) under data and tensor parallelism.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbt_tpu.config as jconfig
from lbt_tpu.data import datasets as jdatasets
from lbt_tpu.models import cifar10_resnet as jax_resnet
from lbt_tpu.nn import Dense as JDense
from lbt_tpu.nn import ReLU as JReLU
from lbt_tpu.nn.model import Model as JModel
from lbt_tpu.train.trainer import Trainer as JTrainer
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.models import cifar10_resnet
from test_torch_parallel import KEY_SEED, _assert_equal_trees, close_trees
from test_torch_trainer import exact_bn_moments
from torch_ranks import WD, build, rank_env, start_ranks


@pytest.fixture
def two_devices(monkeypatch):
    """``lbt_tpu``'s Trainer meshes every device it sees: show it 2."""
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:2])


# ---------------------------------------------------------------------------
# 4. the masked DP eval
# ---------------------------------------------------------------------------

EVAL_N, EVAL_BATCH = 20, 8


def _eval_state():
    model = build({"kind": "resnet8", "cfg": {"noise_mode": "hash"}})
    params, qstate, _ = convert.to_jax_numpy(model)
    # BN running statistics away from their init, so eval reads them
    rng = np.random.default_rng(4)

    def move(q):
        if isinstance(q, dict):
            if set(q) >= {"mean", "var"}:
                return {**q, "mean": rng.normal(0, .3, q["mean"].shape)
                        .astype(np.float32),
                        "var": rng.uniform(.5, 2., q["var"].shape)
                        .astype(np.float32)}
            return {k: move(v) for k, v in q.items()}
        return q
    return params, move(qstate)


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    params, qstate = _eval_state()
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (EVAL_N, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (EVAL_N,)).astype(np.int32)
    jobs = {f: {"kind": "masked_eval", "faithful": f, "params": params,
                "qstate": qstate, "x": x, "y": y, "eval_batch": EVAL_BATCH,
                "model": {"kind": "resnet8", "cfg": {"noise_mode": "hash"}},
                "key": keys.fold_in(keys.base_key(KEY_SEED), 0xE7A1)}
            for f in (False, True)}
    out = start_ranks(tmp_path_factory.mktemp("eval"), jobs, 2)()
    return params, qstate, x, y, out


@pytest.mark.parametrize("faithful", [False, True])
def test_masked_dp_eval_matches_lbt_tpu(eval_runs, faithful, two_devices):
    """20 images at eval batch 8 (a ragged last batch, padded) on 2 ranks
    against ``lbt_tpu``'s ``Trainer._evaluate_dp`` on a 2-device mesh:
    loss and accuracy at rtol 1e-5.  Every rank draws its rows' noise at
    their place in the global batch, and under ``faithful_eval`` BN takes
    the global padded batch's moments (``lbt_tpu``'s made exact, as
    ``test_torch_trainer``'s faithful eval compares them)."""
    params, qstate, x, y, port = eval_runs
    cfg = jconfig.QuantConfig.uniform(8, noise_mode="hash",
                                      faithful_eval=faithful)
    tc = jconfig.TrainConfig(data_parallel=True, eval_batch_size=EVAL_BATCH,
                             batch_size=EVAL_BATCH, seed=KEY_SEED)
    jtr = JTrainer(jax_resnet(cfg, 8, weight_decay=WD), tc,
                   {"train": (x, y), "test": (x, y)})
    jtr.params = jax.tree.map(jnp.asarray, params)
    jtr.qstate = jax.tree.map(jnp.asarray, qstate)
    with exact_bn_moments(faithful):
        want = jtr.evaluate()
    for r in range(2):
        got = port[r][faithful]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["accuracy"], want["accuracy"],
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# 5. the Trainer
# ---------------------------------------------------------------------------

N_TRAIN, N_TEST, TBATCH, TEVAL = 32, 20, 8, 8
TRAIN_TC = dict(batch_size=TBATCH, eval_batch_size=TEVAL, seed=KEY_SEED,
                n_epoch=1, log_every=1, weight_decay=WD)


def _trainer_job(**kw):
    job = {"kind": "trainer", "n_train": N_TRAIN, "n_test": N_TEST,
           "cfg": {"noise_mode": "hash"}, "tc": dict(TRAIN_TC),
           "augment": True}
    for k, v in kw.items():
        if k == "tc":
            job["tc"].update(v)
        else:
            job[k] = v
    return job


def _orbax_mix(shards):
    """What ``lbt_tpu``'s checkpoint makes of a replicated leaf whose
    shards differ: Orbax writes slice ``k`` of the first axis that divides
    by the number of replicas from replica ``k`` (the whole leaf from
    replica 0 where none does)."""
    n, a = len(shards), shards[0]
    ax = next((i for i, d in enumerate(a.shape) if d % n == 0), None)
    if ax is None:
        return a
    return np.concatenate([np.split(s, n, axis=ax)[k]
                           for k, s in enumerate(shards)], axis=ax)


def _tree_mix(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_mix([t[k] for t in trees]) for k in trees[0]}
    return _orbax_mix(trees)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The port's 2-rank runs: the compared epoch; 2 epochs straight and
    1 + 1 resumed; 1 epoch with the low-bit all-reduce, then a restore."""
    tmp = tmp_path_factory.mktemp("trainer")
    ck = {k: str(tmp / k) for k in ("straight", "resumed", "lowbit")}
    two = {"n_epoch": 2, "checkpoint_every_epochs": 1}
    jobs = {
        "epoch": _trainer_job(epochs=1, logdir=str(tmp / "log{rank}"),
                              augment=False),
        "scan": _trainer_job(epochs=1, augment=False,
                             tc={"scan_steps": 3}),
        "straight": _trainer_job(train=True, tc=dict(
            two, checkpoint_dir=ck["straight"])),
        "first": _trainer_job(train=True, tc=dict(
            checkpoint_dir=ck["resumed"])),
        "resumed": _trainer_job(train=True, tc=dict(
            two, checkpoint_dir=ck["resumed"])),
        "lowbit": _trainer_job(train=True, tc=dict(
            lowbit_allreduce=True, checkpoint_dir=ck["lowbit"])),
        "lowbit_restored": _trainer_job(restore_only=True, tc=dict(
            lowbit_allreduce=True, checkpoint_dir=ck["lowbit"])),
    }
    return tmp, start_ranks(tmp / "ranks", jobs, 2)()


def test_trainer_matches_lbt_tpu(trainer_runs, two_devices):
    """1 epoch of 4 steps (global batch 8) and the eval (20
    images at batch 8) of the port's 2-rank Trainer against
    ``lbt_tpu``'s Trainer on a 2-device mesh from the same weights:
    exponents bitwise; parameters, velocity and BN state at rtol 1e-5,
    atol 1e-6 (tighter than the single-device Trainer test's); eval
    loss and accuracy at rtol 1e-5."""
    _, port = trainer_runs
    data = jdatasets.load_dataset("cifar10", n_train=N_TRAIN, n_test=N_TEST)
    tc = jconfig.TrainConfig(data_parallel=True, **TRAIN_TC)
    cfg = jconfig.QuantConfig.uniform(8, noise_mode="hash")
    jtr = JTrainer(jax_resnet(cfg, 8, weight_decay=WD), tc, data)
    model = cifar10_resnet(tconfig.QuantConfig.uniform(
        8, noise_mode="hash"), 8, weight_decay=WD).init(
            torch.Generator().manual_seed(KEY_SEED))
    params, qstate, _ = convert.to_jax_numpy(model)
    jtr.params = jax.tree.map(jnp.asarray, params)
    jtr.qstate = jax.tree.map(jnp.asarray, qstate)
    jtr.train_epoch(0)
    want = jtr.evaluate()
    got = port[0]["epoch"]
    assert got["step"] == jtr.step == N_TRAIN // TBATCH
    for k, tree in (("qstate", jtr.qstate), ("params", jtr.params),
                    ("velocity", jtr.velocity)):
        close_trees(got[k], jax.tree.map(np.asarray, tree), k)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(got["eval"][k], want[k], rtol=1e-5)


def test_trainer_ranks_hold_equal_state(trainer_runs):
    """Every run ends with both ranks' replicated state bitwise equal and
    the same eval."""
    _, port = trainer_runs
    for job in ("epoch", "straight", "resumed", "lowbit"):
        a, b = port[0][job], port[1][job]
        for k in ("params", "qstate", "velocity"):
            _assert_equal_trees(a[k], b[k], f"{job} {k}")
        assert a["eval"] == b["eval"]


def test_trainer_runs_scan_steps_step_by_step_data_parallel(trainer_runs):
    """Data parallel, ``scan_steps=3`` is ignored, as ``lbt_tpu``'s
    Trainer ignores it there: no K-step block, and the epoch equals the
    one run without it bit for bit on both ranks."""
    _, port = trainer_runs
    for r in range(2):
        a, b = port[r]["scan"], port[r]["epoch"]
        assert not a["scanned"] and a["step"] == b["step"]
        for k in ("params", "qstate", "velocity"):
            _assert_equal_trees(a[k], b[k], f"rank {r} {k}")
        assert a["eval"] == b["eval"]


def test_trainer_only_rank0_writes(trainer_runs):
    """Rank 0 writes ``experiment.log`` and ``metrics.jsonl`` and every
    checkpoint; rank 1 writes none of them."""
    tmp, port = trainer_runs
    assert (tmp / "log0" / "experiment.log").is_file()
    rows = [json.loads(s) for s in
            (tmp / "log0" / "metrics.jsonl").read_text().splitlines()]
    assert any("train/loss" in r for r in rows)
    assert not (tmp / "log1").exists()
    for job in ("straight", "first", "resumed", "lowbit"):
        assert port[0][job]["saves"] and not port[1][job]["saves"], job
    assert port[0]["straight"]["saves"] == [4, 8]


def test_trainer_resume_is_bitwise(trainer_runs):
    """1 epoch, then a new Trainer resuming to 2, equals 2 epochs
    straight, bit for bit, on both ranks."""
    _, port = trainer_runs
    for r in range(2):
        a, b = port[r]["straight"], port[r]["resumed"]
        assert a["step"] == b["step"] == 2 * N_TRAIN // TBATCH
        for k in ("params", "qstate", "velocity"):
            _assert_equal_trees(a[k], b[k], f"rank {r} {k}")
        assert a["eval"] == b["eval"]


def test_trainer_resume_restores_ebuf_as_lbt_tpu(trainer_runs, tmp_path,
                                                 two_devices):
    """The low-bit all-reduce's ``ebuf`` differs from rank to rank, and a
    checkpoint holds one leaf of it.  ``lbt_tpu``'s (checked here on a
    toy model: 1 epoch on a 2-device mesh, save, restore) holds Orbax's
    mix of the shards; the port's holds the same mix of its ranks', and a
    resume gives it to every rank."""
    cfg = jconfig.QuantConfig.uniform(8, stochastic=False)
    toy = JModel("toy", [JDense("d1", cfg, 20, 64), JReLU(),
                         JDense("d2", cfg, 64, 4)],
                 input_shape=(20,), num_classes=4, cfg=cfg)
    rng = np.random.default_rng(0)
    data = {"train": (rng.normal(0, 1, (32, 20)).astype(np.float32),
                      rng.integers(0, 4, 32).astype(np.int32)),
            "test": (rng.normal(0, 1, (8, 20)).astype(np.float32),
                     rng.integers(0, 4, 8).astype(np.int32))}
    tc = jconfig.TrainConfig(batch_size=8, n_epoch=1, data_parallel=True,
                             lowbit_allreduce=True, log_every=1,
                             checkpoint_dir=str(tmp_path / "ck"))
    jtr = JTrainer(toy, tc, data)
    jtr.train_epoch(0)
    jtr.save()
    shards = [jax.tree.map(lambda a, i=i: np.asarray(
        a.addressable_shards[i].data), jtr.ebuf) for i in range(2)]
    again = JTrainer(toy, tc, data)
    assert again.maybe_restore()
    _assert_equal_trees(jax.tree.map(np.asarray, again.ebuf),
                        _tree_mix(shards))
    assert any(not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(shards[0]), jax.tree.leaves(shards[1])))

    _, port = trainer_runs
    mixed = _tree_mix([port[r]["lowbit"]["ebuf"] for r in range(2)])
    for r in range(2):
        _assert_equal_trees(port[r]["lowbit_restored"]["ebuf"], mixed,
                            f"rank {r}")


# ---------------------------------------------------------------------------
# 6. the CLI
# ---------------------------------------------------------------------------

def test_cli_trains_data_parallel_under_torchrun(tmp_path):
    """``torch.distributed.run`` with 2 ranks on the CPU, the low-bit
    all-reduce on the int8 ring: exit 0, finite logged losses, one
    ``experiment.log``, ``metrics.jsonl`` and checkpoint written by rank
    0, an eval with a ragged padded last batch."""
    exp = tmp_path / "exp"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "lbt_tpu_torch.main",
           "--device", "cpu", "--data_parallel", "--lowbit_allreduce",
           "--lowbit_wire", "int8", "--model", "CIFAR10_Resnet20",
           "--noise_mode", "hash", "--n_train", "32", "--n_test", "20",
           "--batch_size", "8", "--n_epoch", "1", "--log_every", "1",
           "--exp_path", str(exp)]
    out = subprocess.run(cmd, cwd=tmp_path, env=rank_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rows = [json.loads(s) for s in
            (exp / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 4 and all(math.isfinite(v) for v in losses)
    assert any("test/loss" in r for r in rows)
    log = (exp / "experiment.log").read_text()
    assert log.count("Start of experiment") == 1
    assert os.listdir(exp / "ckpt") == ["4"]


def _torchrun_cli(tmp_path, name, flags):
    """``lbt_tpu_torch.main`` on ResNet-20 under ``torch.distributed.run``
    with 2 ranks on the CPU, 1 epoch of 4 steps of 8 and an eval; returns
    the logged train losses' steps."""
    exp = tmp_path / name
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "lbt_tpu_torch.main",
           "--device", "cpu", "--model", "CIFAR10_Resnet20", "--noise_mode",
           "hash", "--n_train", "32", "--n_test", "20", "--batch_size", "8",
           "--n_epoch", "1", "--log_every", "1", "--exp_path", str(exp),
           *flags]
    out = subprocess.run(cmd, cwd=tmp_path, env=rank_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rows = [json.loads(s) for s in
            (exp / "metrics.jsonl").read_text().splitlines()]
    assert all(math.isfinite(r["train/loss"]) for r in rows
               if "train/loss" in r)
    assert any("test/loss" in r for r in rows)
    return [r["step"] for r in rows if "train/loss" in r]


def test_cli_refuses_tensor_parallelism(tmp_path):
    """``--tensor_parallel 2`` is accepted on every route beside the
    data-parallel flags, and ROADMAP queue 1 item 13's flags, refused
    until they were ported, run under it and under ``--data_parallel``:
    ``--remat_bn --bn_residual_q16 --scan_steps 2`` on 2 ranks.  At
    ``--tensor_parallel 2`` (one data index, not data parallel) the
    steps run in blocks of 2 and the losses are logged a block at a time;
    data parallel, ``scan_steps`` is ignored, as ``lbt_tpu`` ignores it,
    and every step is logged."""
    from lbt_tpu_torch.main import build_parser, quant_config
    tp = ["--data_parallel", "--tensor_parallel", "2"]
    for argv in (tp + ["--engine", "sim"], tp + ["--engine", "sim_bf16"],
                 tp + ["--bits", "32"], tp + ["--bits_g", "16"]):
        args = build_parser().parse_args(argv)
        assert args.tensor_parallel == 2 and quant_config(args)
    flags = ["--remat_bn", "--bn_residual_q16", "--scan_steps", "2"]
    assert _torchrun_cli(tmp_path, "tp", tp + flags) == [2, 4]
    assert _torchrun_cli(tmp_path, "dp", ["--data_parallel"] + flags) == [
        1, 2, 3, 4]
