"""The port's Trainer, eval step, checkpoints, metrics and CLI held against
lbt_tpu on the CPU, with CIFAR ResNet-8 under
``QuantConfig.uniform(8, noise_mode='hash')``:

- the eval step and ``Trainer.evaluate`` (a ragged final batch, both
  weighting modes, the eval key): loss at rtol 1e-5, accuracy exact;
- what the Trainer feeds its train step over 3 epochs (batches, steps,
  learning rates, the key, the momentum reset): bitwise;
- 2 epochs x 2 steps from the same weights: exponents bitwise, floats at
  the tolerances of ``test_torch_train.test_train_step_matches_lbt_tpu``;
- resume after a save, and after SIGTERM, bitwise equal to the
  uninterrupted run (the port alone);
- the metrics' tags and values, and the CLI.
"""

import contextlib
import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbt_tpu.config as jconfig
import lbt_tpu.nn.norm as jnorm
from lbt_tpu.data import datasets as jdatasets
from lbt_tpu.models import build_model as jbuild_model
from lbt_tpu.models import cifar10_resnet as jax_resnet
from lbt_tpu.train.trainer import Trainer as JTrainer
from lbt_tpu.utils.logging import MetricsWriter as JMetricsWriter
from lbt_tpu.utils.tb import read_events
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.data.datasets import load_dataset, make_augment
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.main import main
from lbt_tpu_torch.models import build_model, cifar10_resnet
from lbt_tpu_torch.nn.norm import batch_moments, code_moments, sqrt_f32
from lbt_tpu_torch.train import checkpoint as ckpt
from lbt_tpu_torch.train.trainer import Trainer
from lbt_tpu_torch.utils.logging import MetricsWriter
from lbt_tpu_torch.utils.profiling import START_STEP, StepProfiler
from test_torch_train import _compare_trees, _lsb

pytest_plugins = ["torch_suite"]

_REPO = str(pathlib.Path(__file__).resolve().parent.parent)
WD = 2e-4


def _configs(**kw):
    kw = {"noise_mode": "hash", **kw}
    return (jconfig.QuantConfig.uniform(8, **kw),
            tconfig.QuantConfig.uniform(8, **kw))


def _train_configs(**kw):
    return jconfig.TrainConfig(**kw), tconfig.TrainConfig(**kw)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize_bn(qstate, rng):
    """BN running statistics away from their init, so eval reads them."""
    if isinstance(qstate, dict):
        if set(qstate) >= {"mean", "var"}:
            return {**qstate,
                    "mean": rng.normal(0, 0.3, qstate["mean"].shape)
                    .astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, qstate["var"].shape)
                    .astype(np.float32)}
        return {k: _randomize_bn(v, rng) for k, v in qstate.items()}
    return qstate


def _pair(cfgs, tcs, data, weights=None):
    """lbt_tpu's and the port's Trainer on ResNet-8 with lbt_tpu's
    initial weights (or ``weights``) in both; returns (jtr, ttr, params,
    qstate) with numpy trees."""
    (jcfg, tcfg), (jtc, ttc) = cfgs, tcs
    jtr = JTrainer(jax_resnet(jcfg, 8, weight_decay=WD), jtc, data)
    params, qstate = weights or (_numpy(jtr.params), _numpy(jtr.qstate))
    jtr.params = jax.tree.map(jnp.asarray, params)
    jtr.qstate = jax.tree.map(jnp.asarray, qstate)
    ttr = Trainer(cifar10_resnet(tcfg, 8, weight_decay=WD), ttc, data,
                  device="cpu")
    convert.from_jax_numpy(ttr.model, params, qstate)
    return jtr, ttr, params, qstate


# ---------------------------------------------------------------------------
# eval step, evaluate, metrics
# ---------------------------------------------------------------------------


def _exact_mean(x, axes):
    """``jnp.mean`` over ``axes`` computed in float64 on the host and
    rounded once to f32."""
    shape = tuple(n for i, n in enumerate(x.shape) if i not in axes)
    return jax.pure_callback(
        lambda a: np.mean(np.asarray(a, np.float64), axis=axes)
        .astype(np.float32), jax.ShapeDtypeStruct(shape, jnp.float32), x)


@contextlib.contextmanager
def exact_bn_moments(faithful):
    """lbt_tpu's BatchNorm with exact batch moments (where ``faithful``):
    XLA's f32 reductions of the squared codes round (see
    ``test_bn_batch_moments_exact_where_lbt_tpu_rounds``), the port's do
    not.  Only the trace inside the block sees the change."""
    if not faithful:
        yield
        return
    shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    shim.mean = _exact_mean
    saved, jnorm.jnp = jnorm.jnp, shim
    try:
        yield
    finally:
        jnorm.jnp = saved


def test_bn_batch_moments_exact_where_lbt_tpu_rounds():
    """A fault of lbt_tpu found by this port: its BN batch moments are
    XLA f32 means, and at a batch of 32 the sum of squared codes runs past
    2**24, so the second moment (hence var) is off by ~1e-5 relative.
    The port's moments from integer code sums equal float64 rounded once.
    Train-mode BN (training, faithful eval) then flips a stochastic code
    wherever a normalized value lies within that error of a rounding
    boundary: faithful-eval losses of a batch of 32 differ from lbt_tpu's
    by up to ~2e-3 relative, and agree at 1e-7 once lbt_tpu's moments are
    exact (``exact_bn_moments``)."""
    rng = np.random.default_rng(0)
    codes = rng.integers(-128, 128, (32, 32, 32, 16)).astype(np.int8)
    mult = torch.tensor(32.0)
    xq = codes.astype(np.float64) / 32.0
    want_mean = xq.mean(axis=(0, 1, 2))
    want_var = (xq * xq).mean(axis=(0, 1, 2)) - want_mean ** 2
    mean, var = batch_moments(code_moments(torch.from_numpy(codes)),
                              32 * 32 * 32, mult)
    np.testing.assert_array_equal(mean.numpy(), want_mean.astype(np.float32))
    np.testing.assert_array_equal(var.numpy(), want_var.astype(np.float32))
    m2 = np.asarray(jax.jit(lambda x: jnp.mean(jnp.square(x), (0, 1, 2)))(
        xq.astype(np.float32)))
    want_m2 = (xq * xq).mean(axis=(0, 1, 2))
    assert np.abs(m2 / want_m2 - 1).max() > 1e-6


def test_bn_sqrt_correctly_rounded_as_lbt_tpu():
    """A fault of the port found on the card: ``torch.sqrt`` of f32 on the
    CPU is one ulp off near ties, so BN's ``sqrt(var + eps)`` parted from
    the card's (and XLA's) in a whole channel, and a batch-statistic eval
    of 1000 images drifted by 7.5e-4 in loss.  ``sqrt_f32`` equals XLA's
    root everywhere."""
    v = np.random.default_rng(0).uniform(0.01, 1e4, 200_000).astype(
        np.float32)
    v[0] = 75.14901733398438  # the stem BN's var + eps in that eval
    want = np.asarray(jax.jit(jnp.sqrt)(v))
    np.testing.assert_array_equal(sqrt_f32(torch.from_numpy(v)).numpy(),
                                  want)
    np.testing.assert_array_equal(want, np.sqrt(v))


@pytest.fixture(scope="module", params=[False, True],
                ids=["count_weighted", "faithful"])
def eval_pair(request):
    """A test set of 100 in batches of 32 (the last one 4)."""
    data = jdatasets.load_dataset("cifar10", n_train=8, n_test=100)
    jtr = JTrainer(jax_resnet(_configs()[0], 8, weight_decay=WD),
                   jconfig.TrainConfig(), data)
    weights = (_numpy(jtr.params),
               _randomize_bn(_numpy(jtr.qstate), np.random.default_rng(4)))
    return _pair(_configs(faithful_eval=request.param),
                 _train_configs(batch_size=4, eval_batch_size=32, seed=3),
                 data, weights)


def test_eval_step_matches_lbt_tpu(eval_pair):
    """One batch with the Trainer's eval key: loss at rtol 1e-5, accuracy
    and count exact, no state touched; another key gives another loss
    (the layers round stochastically in eval, as lbt_tpu's).  Faithful
    eval takes batch moments: lbt_tpu's are made exact here."""
    jtr, ttr, _, _ = eval_pair
    x, y = (a[:32] for a in jtr.dataset["test"])
    jkey = jax.random.fold_in(jtr.base_key, 0xE7A1)
    key = keys.fold_in(ttr.base_key, 0xE7A1)
    np.testing.assert_array_equal(key, jax.random.key_data(jkey))
    before = {k: v.clone() for k, v in ttr.model.net.state_dict().items()}
    with exact_bn_moments(ttr.faithful):
        want = jax.device_get(jtr.eval_step(jtr.params, jtr.qstate, x, y,
                                            jkey))
    got = ttr.eval_step(ttr.model, torch.from_numpy(x), torch.from_numpy(y),
                        key)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    assert got["accuracy"].item() == float(want["accuracy"])
    assert got["count"] == float(want["count"]) == 32
    assert not got["loss"].requires_grad
    for k, v in ttr.model.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    other = ttr.eval_step(ttr.model, torch.from_numpy(x),
                          torch.from_numpy(y), keys.fold_in(key, 1))
    assert other["loss"].item() != got["loss"].item()


def test_evaluate_matches_lbt_tpu(eval_pair):
    jtr, ttr, _, _ = eval_pair
    with exact_bn_moments(ttr.faithful):
        want = jtr.evaluate()
    got = ttr.evaluate()
    assert set(got) == set(want) == {"loss", "accuracy"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_eval_matches_unpatched_lbt_tpu(eval_pair):
    """The eval step and ``evaluate`` against lbt_tpu as it stands.  Its
    faithful eval rounds the BN batch moments (see
    ``test_bn_batch_moments_exact_where_lbt_tpu_rounds``), so there the
    loss is held at rtol 2e-3: measured 5.1e-4 (step) and 6.7e-6
    (evaluate) at this seed, 1.1e-3 and 4.5e-4 at seed 4, accuracy equal
    in both.  Count-weighted eval reads running statistics: rtol 1e-5."""
    jtr, ttr, _, _ = eval_pair
    rtol = 2e-3 if ttr.faithful else 1e-5
    x, y = (a[:32] for a in jtr.dataset["test"])
    want = jax.device_get(jtr.eval_step(
        jtr.params, jtr.qstate, x, y,
        jax.random.fold_in(jtr.base_key, 0xE7A1)))
    got = ttr.eval_step(ttr.model, torch.from_numpy(x), torch.from_numpy(y),
                        keys.fold_in(ttr.base_key, 0xE7A1))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=rtol)
    assert got["accuracy"].item() == float(want["accuracy"])
    want, got = jtr.evaluate(), ttr.evaluate()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=rtol)
    assert got["accuracy"] == want["accuracy"]


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_metrics_writer_matches_lbt_tpu(tmp_path, eval_pair):
    """The same weights give the same tags and values: rtol 1e-6, and
    atol 1e-8 for a parameter mean that cancels to ~1e-5, where only the
    f32 resolution of the summation order is left (3.5e-10 seen).  The
    port's TensorBoard mirror reads back through lbt_tpu's reader with
    the JSONL rows' steps, tags and values (rounded to f32)."""
    jtr, ttr, _, _ = eval_pair
    jw = JMetricsWriter(str(tmp_path / "j"))
    jw.write(3, {"loss": np.asarray(1.5, np.float32)}, prefix="train/")
    jw.write_exponents(3, jtr.qstate)
    jw.write_param_means(3, jtr.params)
    jw.close()
    tw = MetricsWriter(str(tmp_path / "t"))
    tw.write(3, {"loss": torch.tensor(1.5)}, prefix="train/")
    tw.write_exponents(3, ttr.model)
    tw.write_param_means(3, ttr.model)
    tw.close()
    want, got = (_rows(tmp_path / d / "metrics.jsonl") for d in ("j", "t"))
    assert len(got) == len(want) == 3
    assert any(k.startswith("exp/") for k in got[1])
    assert any(k.startswith("param/") for k in got[2])
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k != "time":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-8,
                                           err_msg=k)
    (events,) = (tmp_path / "t").glob("events.out.tfevents.*")
    mirrored = list(read_events(str(events)))
    assert len(mirrored) == len(got)
    for (step, values), row in zip(mirrored, got):
        assert step == row["step"]
        assert values == {k: float(np.float32(v)) for k, v in row.items()
                          if k not in ("step", "time")}


# ---------------------------------------------------------------------------
# the feed and the trajectory
# ---------------------------------------------------------------------------


def test_trainer_feed_matches_lbt_tpu():
    """Over 3 epochs, with an LR decay at epoch 1 that resets the
    momentum, both Trainers hand their train step the same batches,
    steps, learning rates (f32), key and velocity, bitwise."""
    data = jdatasets.load_dataset("cifar10", n_train=24, n_test=8)
    kw = dict(batch_size=8, n_epoch=3, lr=0.1, lr_decay_epochs=(1,),
              reset_momentum_on_decay=True, seed=5)
    jtr = JTrainer(jax_resnet(_configs()[0], 8), jconfig.TrainConfig(**kw),
                   data)
    ttr = Trainer(cifar10_resnet(_configs()[1], 8),
                  tconfig.TrainConfig(**kw), data, device="cpu")
    jtr.velocity = jax.tree.map(jnp.ones_like, jtr.velocity)
    for v in ttr.velocity.values():
        v.fill_(1.0)
    jfeed, tfeed = [], []

    def jrec(params, qstate, velocity, x, y, step, lr, key):
        jfeed.append((np.asarray(x), np.asarray(y), int(step),
                      np.float32(lr), np.asarray(jax.random.key_data(key)),
                      sum(float(np.abs(v).sum())
                          for v in jax.tree.leaves(velocity))))
        return params, qstate, velocity, {"loss": jnp.float32(0),
                                          "accuracy": jnp.float32(0)}

    def trec(model, velocity, x, y, step, lr, key):
        tfeed.append((x.numpy().copy(), y.numpy().copy(), step,
                      np.float32(lr), np.asarray(key),
                      sum(float(v.abs().sum()) for v in velocity.values())))
        return {"loss": torch.tensor(0.0), "accuracy": torch.tensor(0.0)}

    jtr.train_step, ttr.train_step = jrec, trec
    for epoch in range(3):
        jtr.train_epoch(epoch)
        ttr.train_epoch(epoch)
    assert len(tfeed) == len(jfeed) == 9
    for i, (got, want) in enumerate(zip(tfeed, jfeed)):
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype, i
            np.testing.assert_array_equal(a, b, err_msg=str(i))
    assert [f[3] for f in tfeed] == [np.float32(0.1)] * 3 + [
        np.float32(0.1 * 0.1)] * 6
    assert tfeed[2][5] > 0 and tfeed[3][5] == 0  # momentum reset at 1


@pytest.mark.parametrize("cfg_kw", [
    {}, {"noise_mode": "prng", "noise_impl": "unsafe_rbg"}],
    ids=["hash", "rbg_prng"])
def test_trainer_trajectory_matches_lbt_tpu(cfg_kw):
    """2 epochs x 2 steps (batch 4) from the same weights and key, LR
    decay at epoch 1: exponents bitwise; params, velocity and BN state at
    the tolerances of ``test_train_step_matches_lbt_tpu``.  Under the
    ``hash`` noise and under ``unsafe_rbg`` keys with ``prng`` noise (the
    Trainer's base key of ``noise_impl``, XLA's Philox stream)."""
    data = jdatasets.load_dataset("cifar10", n_train=8, n_test=8)
    jtr, ttr, _, _ = _pair(
        _configs(**cfg_kw), _train_configs(batch_size=4, n_epoch=2, seed=7,
                                   lr_decay_epochs=(1,), log_every=1,
                                   weight_decay=WD),
        data)
    for epoch in range(2):
        jtr.train_epoch(epoch)
        ttr.train_epoch(epoch)
    assert ttr.step == jtr.step == 4
    p, q, v = convert.to_jax_numpy(ttr.model, ttr.velocity)
    jq_np = _numpy(jtr.qstate)

    def lsb_of(path):
        node = jq_np
        parts = path.strip("/").split("/")
        for part in parts[:-1]:
            node = node[part]
        exps = node.get("exp", {}) if isinstance(node, dict) else {}
        site = {"W": "w", "gamma": "gamma", "beta": "beta"}.get(parts[-1],
                                                                "x")
        return _lsb(8, exps.get(site, 2))

    _compare_trees(q, jq_np, lambda path: _lsb(8, 2))
    _compare_trees(p, _numpy(jtr.params), lsb_of)
    _compare_trees(v, _numpy(jtr.velocity), lsb_of)


# ---------------------------------------------------------------------------
# checkpoints and resume (the port alone)
# ---------------------------------------------------------------------------


def _port_trainer(ckpt_dir, n_epoch, seed=2):
    cfg = tconfig.QuantConfig.uniform(8, noise_mode="hash")
    tc = tconfig.TrainConfig(batch_size=4, n_epoch=n_epoch, seed=seed,
                             lr_decay_epochs=(1,), checkpoint_every_epochs=1,
                             checkpoint_dir=str(ckpt_dir), eval_batch_size=8,
                             weight_decay=WD)
    return Trainer(cifar10_resnet(cfg, 8, weight_decay=WD), tc,
                   load_dataset("cifar10", n_train=12, n_test=8),
                   augment=make_augment("cifar10"), device="cpu")


def _state(tr):
    out = {f"net.{k}": v for k, v in tr.model.net.state_dict().items()}
    out.update({f"velocity.{k}": v for k, v in tr.velocity.items()})
    return out


def test_resume_is_bitwise_exact(tmp_path):
    """1 epoch, save, a fresh Trainer resumes and runs 1 more: the state
    and the final eval equal 2 uninterrupted epochs bit for bit, with
    augmentation on."""
    ref = _port_trainer(tmp_path / "a", 2)
    ref_ev = ref.train()
    _port_trainer(tmp_path / "b", 1).train()
    assert ckpt.latest_step(tmp_path / "b") == 3
    res = _port_trainer(tmp_path / "b", 2)
    calls = []
    step_fn = res.train_step
    res.train_step = lambda *a: calls.append(a[4]) or step_fn(*a)
    res_ev = res.train()
    assert calls == [3, 4, 5], "the second run did not resume at step 3"
    assert res.step == ref.step == 6 and res.epoch == ref.epoch == 2
    got, want = _state(res), _state(ref)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert res_ev == ref_ev


def test_checkpoint_layout_and_checks(tmp_path):
    """A step directory per save, the newest three kept, a save cut short
    (no ``state.pt``) is not a checkpoint, and a state that does not fit
    the template raises."""
    tr = _port_trainer(tmp_path, 1)
    for step in (1, 2, 3, 4):
        tr.step = step
        tr.save()
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "4"]
    os.makedirs(tmp_path / "9")
    (tmp_path / "9" / "state.pt.tmp").write_bytes(b"cut short")
    assert ckpt.latest_step(tmp_path) == 4
    assert ckpt.latest_step(tmp_path / "none") is None
    state = ckpt.restore_checkpoint(tmp_path, tr._state())
    assert state["step"] == 4 and state["epoch"] == 0
    bad = tr._state()
    bad["velocity"] = dict(bad["velocity"])
    bad["velocity"].popitem()
    with pytest.raises(ValueError, match="unexpected"):
        ckpt.restore_checkpoint(tmp_path, bad)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "none", tr._state())


_CHILD = r"""
import sys, time
import numpy as np
import torch
from lbt_tpu_torch.config import QuantConfig, TrainConfig
from lbt_tpu_torch.nn.layers import AvgPool, Conv2d, Dense, Flatten, ReLU
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.train.trainer import Trainer

ckpt_dir, out, slow = sys.argv[1], sys.argv[2], sys.argv[3] == "slow"
cfg = QuantConfig.uniform(8, noise_mode="hash")
model = Model("tiny", [
    Conv2d("c1", cfg, (3, 3, 1, 4), (1, 1), "SAME"),
    ReLU(),
    AvgPool(ksize=(2, 2), strides=(2, 2)),
    Flatten(),
    Dense("d1", cfg, 64, 4),
], input_shape=(8, 8, 1), num_classes=4, cfg=cfg)
rng = np.random.default_rng(0)
x = rng.normal(0, 0.7, (256, 8, 8, 1)).astype(np.float32)
w = rng.normal(0, 1, (64, 4)).astype(np.float32)
y = (x.reshape(256, 64) @ w).argmax(-1).astype(np.int32)
tc = TrainConfig(lr=0.05, batch_size=32, n_epoch=5, log_every=1000,
                 checkpoint_every_epochs=1, checkpoint_dir=ckpt_dir,
                 eval_batch_size=64)


class SlowTrainer(Trainer):
    # the preempted run stalls in its third eval, before the third
    # checkpoint, so SIGTERM lands mid-run (the parent kills it at once;
    # the long sleep only leaves a loaded machine time to deliver it)
    def evaluate(self):
        if slow and self.epoch >= 2:
            print("EPOCH_MARK", self.epoch, flush=True)
            time.sleep(30)
        return super().evaluate()


tr = SlowTrainer(model, tc, {"train": (x, y), "test": (x[:100], y[:100])},
                 device="cpu")
ev = tr.train()
torch.save({"net": tr.model.net.state_dict(), "velocity": tr.velocity,
            "step": tr.step, "eval": ev}, out)
print("RESULT", tr.step, flush=True)
"""


def _spawn(script, ckpt_dir, out, mode="fast"):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, str(script), str(ckpt_dir), str(out), mode],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _finish(p, timeout=120):
    try:
        return p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        raise


def test_sigterm_resume_reproduces_uninterrupted_run(tmp_path):
    """A child Trainer killed by SIGTERM mid-run restarts from its last
    epoch checkpoint and ends bit for bit where the uninterrupted run
    ends."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    out, err = _finish(_spawn(script, tmp_path / "ckpt_ref",
                              tmp_path / "ref.pt"))
    assert "RESULT 40" in out, err[-3000:]

    p = _spawn(script, tmp_path / "ckpt_pre", tmp_path / "pre.pt", "slow")
    deadline, marked = time.time() + 120, False
    while time.time() < deadline:
        line = p.stdout.readline()
        if not line:
            break
        if line.startswith("EPOCH_MARK"):
            marked = True
            break
    assert marked, "child never reached the mid-run marker"
    p.send_signal(signal.SIGTERM)
    p.communicate(timeout=60)
    assert p.returncode == -signal.SIGTERM
    assert not (tmp_path / "pre.pt").exists()
    assert ckpt.latest_step(tmp_path / "ckpt_pre") == 16  # epoch 2 saved

    out, err = _finish(_spawn(script, tmp_path / "ckpt_pre",
                              tmp_path / "pre.pt"))
    assert "Resumed from" in err and "@ step 16" in err, err[-3000:]
    assert "RESULT 40" in out, err[-3000:]
    ref, got = (torch.load(tmp_path / f, weights_only=True)
                for f in ("ref.pt", "pre.pt"))
    assert got["eval"] == ref["eval"]
    for part in ("net", "velocity"):
        assert set(got[part]) == set(ref[part])
        for k in ref[part]:
            assert torch.equal(got[part][k], ref[part][k]), (part, k)


# ---------------------------------------------------------------------------
# models and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["lbt_tpu", "lbt_tpu_torch"])
def test_build_model_takes_main_kwargs(pkg):
    """``main.py`` builds its model with ``dropout_keep`` and
    ``weight_decay``; both packages take them."""
    if pkg == "lbt_tpu":
        m = jbuild_model("CIFAR10_Resnet20", _configs()[0],
                         dropout_keep=0.5, weight_decay=WD)
    else:
        m = build_model("CIFAR10_Resnet20", _configs()[1], dropout_keep=0.5,
                        weight_decay=WD)
    assert m.decay_tree()["conv1"] == {"W": WD}
    if pkg == "lbt_tpu_torch":
        # main.py's --gradient_buffer (refused before GradientBuffer was
        # ported)
        gb = build_model("CIFAR10_Resnet20", _configs()[1],
                         gradient_buffer_batch=32)
        names = [la.name for la in gb.net.layers]
        assert names[:3] == ["conv1", "grad-buffer-stem", "conv1-bn"]
        assert names[-1] == "grad-buffer-head"


def test_cli_trains_and_writes(tmp_path):
    exp = tmp_path / "exp"
    tr = main(["--model", "CIFAR10_Resnet20", "--noise_mode", "hash",
               "--device", "cpu", "--n_train", "64", "--n_test", "40",
               "--batch_size", "16", "--n_epoch", "1", "--log_every", "2",
               "--exp_path", str(exp)])
    assert tr.step == 4 and tr.epoch == 1
    log = (exp / "experiment.log").read_text()
    assert "End of experiment" in log and "first train step" in log
    tags = set().union(*_rows(exp / "metrics.jsonl"))
    assert {"train/loss", "train/accuracy", "train/input_stall_frac",
            "test/loss", "test/accuracy", "exp/conv1/exp/x",
            "param/softmax/W_mean"} <= tags
    assert ckpt.latest_step(exp / "ckpt") == 4


@pytest.mark.parametrize("tc_kw,trainer_kw,item", [
    ({"scan_steps": 4}, {}, "item 13"),
])
def test_trainer_refuses_what_it_cannot_run(tc_kw, trainer_kw, item,
                                            tmp_path):
    """What the Trainer refused until ROADMAP queue 1 ``item`` ported it:
    ``scan_steps=4`` over 6 steps of batch 4 (one block of 4, then 2
    steps one by one), augmentation on, equals the eager Trainer bit for
    bit in every state tensor; its ``metrics.jsonl`` rows land a block at
    a time (``log_every=2``: steps 4 and 6, where the eager loop writes
    2, 4 and 6), with no input-stall row."""
    cfg = tconfig.QuantConfig.uniform(8, noise_mode="hash")
    data = load_dataset("cifar10", n_train=24, n_test=8)
    runs = {}
    for name, kw in (("eager", {}), ("scanned", tc_kw)):
        tc = tconfig.TrainConfig(batch_size=4, log_every=2, seed=3, **kw)
        tr = Trainer(cifar10_resnet(cfg, 8, weight_decay=WD), tc, data,
                     augment=make_augment("cifar10"),
                     logdir=str(tmp_path / name), device="cpu",
                     **trainer_kw)
        assert (tr.scan_train_step is not None) == (name == "scanned")
        tr.train_epoch(0)
        tr.metrics.close()
        runs[name] = tr
    eager, scanned = runs["eager"], runs["scanned"]
    assert eager.step == scanned.step == 6
    got, want = _state(scanned), _state(eager)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    steps = {name: [r["step"] for r in _rows(tmp_path / name /
                                             "metrics.jsonl")
                    if "train/loss" in r] for name in runs}
    assert steps == {"eager": [2, 4, 6], "scanned": [4, 6]}
    rows = _rows(tmp_path / "scanned" / "metrics.jsonl")
    assert not any("train/input_stall_frac" in r for r in rows)


@pytest.mark.parametrize("tc_kw", [
    {"data_parallel": True}, {"lowbit_allreduce": True},
    {"data_parallel": True, "lowbit_allreduce": True, "lowbit_wire": "int8"},
])
def test_trainer_runs_data_parallel_flags_on_one_process(tc_kw):
    """The data-parallel flags in one process (no group of more than one
    rank) train on one device, as ``lbt_tpu``'s Trainer does on a single
    device: the plain step, no ``ebuf`` (``tests/test_torch_parallel*.py``
    hold the ranks)."""
    cfg = tconfig.QuantConfig.uniform(8, noise_mode="hash")
    tr = Trainer(cifar10_resnet(cfg, 8), tconfig.TrainConfig(**tc_kw), {},
                 device="cpu")
    assert not tr.dp and tr.ebuf is None and tr.group is None


def test_entry_points_default_to_the_card(monkeypatch):
    """``Predictor`` and ``Trainer`` run on the card unless given
    ``device="cpu"``: without a card the default raises, naming the CPU
    option; with ``device="cpu"`` they run there."""
    from lbt_tpu_torch.infer import Predictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.QuantConfig.uniform(8, noise_mode="hash")
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    data = {"train": (x, rng.integers(0, 10, (4,)).astype(np.int32)),
            "test": (x, rng.integers(0, 10, (4,)).astype(np.int32))}
    tc = tconfig.TrainConfig(batch_size=4, eval_batch_size=4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Predictor(cifar10_resnet(cfg, 8))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(cifar10_resnet(cfg, 8), tc, data)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(cifar10_resnet(cfg, 8), tc, data, device="cuda:0")
    labels = Predictor(cifar10_resnet(cfg, 8), device="cpu")(x)
    assert labels.shape == (4,) and labels.device.type == "cpu"
    tr = Trainer(cifar10_resnet(cfg, 8), tc, data, device="cpu")
    assert tr.device.type == "cpu" and tr.model.device.type == "cpu"
    assert math.isfinite(tr.evaluate()["loss"])


def test_cli_refuses_cuda_without_a_card(tmp_path, capsys):
    """``--device cuda`` (the default) without a card is an error, not a
    quiet run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        main(["--noise_mode", "hash", "--exp_path", str(tmp_path / "exp")])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "exp").exists()


def test_step_profiler_writes_a_chrome_trace(tmp_path):
    prof = StepProfiler(str(tmp_path), steps=2)
    for step in range(START_STEP + 4):
        prof.observe(step)
        torch.ones(8).sum()
    prof.stop()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    off = StepProfiler(str(tmp_path / "off"), steps=0)
    for step in range(START_STEP + 4):
        off.observe(step)
    off.stop()
    assert not (tmp_path / "off").exists()


@pytest.mark.parametrize("argv,msg", [
    ([], None),
    (["--noise_mode", "hash", "--bits", "32"], None),
    (["--noise_mode", "hash", "--engine", "sim_bf16"], None),
    (["--noise_mode", "hash", "--stem_s2d"], None),
    (["--noise_mode", "hash", "--scan_steps", "4"], "--scan_steps 4"),
    (["--noise_mode", "hash", "--data_parallel"], None),
    (["--noise_mode", "hash", "--model", "MNIST"], None),
    (["--noise_mode", "hash", "--gradient_buffer"], None),
    (["--remat_bn"], "--remat_bn"),
    (["--bn_residual_q16"], "--bn_residual_q16"),
    # the float route under tensor parallelism, refused until it was
    # ported: the case keeps its id
    pytest.param(["--noise_mode", "hash", "--tensor_parallel", "2",
                  "--engine", "sim"], None,
                 id="argv10---tensor_parallel 2"),
])
def test_cli_refuses_what_it_cannot_run(tmp_path, argv, msg):
    """What the port's CLI refused before it was ported runs now, and
    gives main.py's config: main.py's defaults (``prng`` noise), the
    FP32 arm, the sim engines, the s2d stem, the reference's small
    models, ``--gradient_buffer``, ``--data_parallel`` and the float
    route under ``--tensor_parallel``; ``--scan_steps 4``, ``--remat_bn``
    and ``--bn_residual_q16`` (``msg``) each train an epoch of 6 steps on
    the CPU, the block of 4 then 2 steps one by one under
    ``--scan_steps``, with finite logged losses."""
    from lbt_tpu_torch.main import build_parser, quant_config
    args = build_parser().parse_args(argv)
    cfg = quant_config(args)
    if msg is None:
        if "32" in argv:
            assert cfg == tconfig.QuantConfig.fp32()
        else:
            assert (cfg.engine, cfg.noise_mode) == (
                args.engine, args.noise_mode)
            assert cfg.stem_s2d == ("--stem_s2d" in argv)
        return
    flag = msg.split()[0][2:]
    assert getattr(cfg if flag != "scan_steps" else args, flag)
    exp = tmp_path / "exp"
    tr = main(argv + ["--device", "cpu", "--model", "CIFAR10_Resnet20",
                      "--n_train", "48", "--n_test", "16", "--batch_size",
                      "8", "--n_epoch", "1", "--log_every", "2",
                      "--exp_path", str(exp)])
    assert tr.step == 6
    assert (tr.scan_train_step is not None) == (flag == "scan_steps")
    assert getattr(tr.model.cfg if flag != "scan_steps" else tr.tc, flag)
    losses = [r["train/loss"] for r in _rows(exp / "metrics.jsonl")
              if "train/loss" in r]
    assert len(losses) == (2 if flag == "scan_steps" else 3)
    assert all(math.isfinite(v) for v in losses)
