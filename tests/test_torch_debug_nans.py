"""The port's loss on labels outside the model's head, and its
``--debug_nans``, held against lbt_tpu on the CPU:

- ``Model.loss_and_acc`` gives what lbt_tpu's ``take_along_axis`` gives
  for a label at or past the head's width or below it: a NaN loss, the
  same finite gradient (that row's ``logz`` part only), accuracy counting
  the example wrong; ``-C..-1`` count from the end, as there;
- under ``train.step.debug_nans`` the train and eval steps raise
  ``FloatingPointError`` exactly where lbt_tpu's jitted steps raise under
  ``jax.debug_nans(True)``: on a NaN output, not on an Inf;
- the CLI's ``--debug_nans`` stops a run whose labels lie outside the head
  at step 0; without it the run logs NaN losses and finishes.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import lbt_tpu.config as jconfig
from lbt_tpu.nn import Dense as JDense
from lbt_tpu.nn import Flatten as JFlatten
from lbt_tpu.nn.model import Model as JModel
from lbt_tpu.train.optim import momentum_init as jmomentum_init
from lbt_tpu.train.step import make_eval_step as jmake_eval_step
from lbt_tpu.train.step import make_train_step as jmake_train_step
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.main import main
from lbt_tpu_torch.nn.layers import Dense, Flatten
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.train.optim import momentum_init
from lbt_tpu_torch.train.step import debug_nans, make_eval_step, make_train_step

pytest_plugins = ["torch_suite"]

C = 10
SHAPE = (4, 4, 3)
BATCH = 4


def _pair(pkg_cfgs, w=None):
    """lbt_tpu's and the port's Flatten -> Dense(48, C) under the same
    config, with the port's seeded weights (or ``w``) in both; returns
    (lbt_tpu model, port model, params, qstate)."""
    jcfg, tcfg = pkg_cfgs
    jm = JModel("tiny", [JFlatten(), JDense("softmax", jcfg, 48, C)],
                input_shape=SHAPE, num_classes=C, cfg=jcfg)
    model = Model("tiny", [Flatten(), Dense("softmax", tcfg, 48, C)],
                  input_shape=SHAPE, num_classes=C, cfg=tcfg)
    model.init(torch.Generator().manual_seed(3))
    params, qstate, _ = convert.to_jax_numpy(model)
    if w is not None:
        params["softmax"]["W"] = w
        convert.from_jax_numpy(model, params, qstate)
    return jm, model, params, qstate


def _hash():
    return (jconfig.QuantConfig.uniform(8, noise_mode="hash"),
            tconfig.QuantConfig.uniform(8, noise_mode="hash"))


def _fp32():
    return jconfig.QuantConfig.fp32(), tconfig.QuantConfig.fp32()


@pytest.mark.parametrize("labels", [
    [0, 9, 3, 5],            # in range
    [10, 3, 11, 400],        # at and past the head's width
    [-1, 2, -10, -11],       # from the end, and below it
    [2 ** 31 - 1, -2 ** 31, 1, 1],
])
def test_loss_on_labels_outside_the_head_matches_lbt_tpu(labels):
    """Loss (NaN where any label is outside ``-C..C-1``), accuracy and the
    gradient of the loss in the logits, against lbt_tpu's; the gradient
    stays finite."""
    jm, model, _, _ = _pair(_hash())
    logits = np.random.default_rng(1).normal(0, 2, (4, C)).astype(np.float32)
    y = np.asarray(labels, np.int32)
    jloss, jacc = jm.loss_and_acc(jnp.asarray(logits), jnp.asarray(y))
    jgrad = jax.grad(lambda lg: jm.loss_and_acc(lg, jnp.asarray(y))[0])(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    loss, acc = model.loss_and_acc(t, torch.from_numpy(y))
    loss.backward()
    outside = [v for v in labels if not -C <= v < C]
    assert math.isnan(loss.item()) == bool(outside) == math.isnan(
        float(jloss))
    if not outside:
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert acc.item() == float(jacc)
    assert np.isfinite(t.grad.numpy()).all()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-8)


def _raises(fn) -> str:
    """The message of the FloatingPointError ``fn`` raises, else ''."""
    try:
        fn()
    except FloatingPointError as e:
        return str(e) or "raised"
    return ""


# (step, case, raises): a label outside the head makes the loss NaN; an
# infinite logit makes the eval loss Inf (no NaN) and the train step's
# gradient NaN
CASES = [
    ("train", "in range", False),
    ("train", "label outside the head", True),
    ("train", "infinite logit", True),
    ("eval", "in range", False),
    ("eval", "label outside the head", True),
    ("eval", "infinite logit", False),
]


@pytest.mark.parametrize("kind,case,raises", CASES)
def test_debug_nans_raises_where_lbt_tpu_raises(kind, case, raises):
    """One step of each package under its NaN switch: both raise, or
    neither; the port names the tensor and the step.  Off, neither raises
    and the losses agree (NaN and Inf included)."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (BATCH,) + SHAPE).astype(np.float32)
    y = rng.integers(0, C, (BATCH,)).astype(np.int32)
    w = None
    if case == "label outside the head":
        y[1] = C
    if case == "infinite logit":
        # fp32 passthrough: class 0's logit overflows to +Inf, the
        # labels' logits stay finite
        x = np.abs(x) + 1.0
        w = np.full((48, C), 0.01, np.float32)
        w[:, 0] = 1e38
        y[:] = 1
    jm, model, params, qstate = _pair(
        _fp32() if case == "infinite logit" else _hash(), w)
    key_data = keys.base_key(7)
    jkey = jax.random.wrap_key_data(np.asarray(key_data, np.uint32))
    if kind == "train":
        jstep = jax.jit(jmake_train_step(jm, jconfig.TrainConfig(),
                                         jit=False))
        jargs = (params, qstate, jmomentum_init(params), jnp.asarray(x),
                 jnp.asarray(y), 0, 0.1, jkey)
        step = make_train_step(model, tconfig.TrainConfig())
        vel = momentum_init(dict(model.net.named_parameters()))

        def run(on):
            snap = {k: t.clone() for k, t in model.net.state_dict().items()}
            with debug_nans(on):
                try:
                    return step(model, vel, torch.from_numpy(x),
                                torch.from_numpy(y), 0, 0.1,
                                key_data)["loss"].item()
                finally:
                    model.net.load_state_dict(snap)
                    for v in vel.values():
                        v.zero_()

        def jrun():
            return float(jstep(*jargs)[3]["loss"])
    else:
        jstep = jmake_eval_step(jm)
        jargs = (params, qstate, jnp.asarray(x), jnp.asarray(y), jkey)
        step = make_eval_step(model)

        def run(on):
            with debug_nans(on):
                return step(model, torch.from_numpy(x), torch.from_numpy(y),
                            key_data)["loss"].item()

        def jrun():
            return float(jstep(*jargs)["loss"])

    with jax.debug_nans(True):
        jmsg = _raises(jrun)
    msg = _raises(lambda: run(True))
    assert bool(msg) == bool(jmsg) == raises, (msg, jmsg)
    if raises and case == "label outside the head":
        where = "train step 0" if kind == "train" else "the eval step"
        assert msg.startswith("invalid value (nan) in loss after " + where)
    # off: neither raises, and the two losses agree
    got, want = run(False), jrun()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert math.isnan(got) == (case == "label outside the head")
    if case == "infinite logit" and kind == "eval":
        assert got == math.inf


@pytest.fixture
def tree_past_the_head(tmp_path):
    """An ImageFolder tree of 12 classes whose training images all lie in
    the last two, labels 10 and 11: past ResNet-20's 10-way head."""
    rng = np.random.default_rng(4)
    for c in range(12):
        (tmp_path / "train" / f"c{c:02d}").mkdir(parents=True)
    for split, n in (("train", 16), ("val", 6)):
        for i in range(n):
            d = tmp_path / split / (f"c{10 + i % 2}" if split == "train"
                                    else f"c{i:02d}")
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (36, 40, 3), np.uint8)).save(
                d / f"{i}.jpeg")
    return tmp_path


def test_cli_debug_nans_stops_a_run_with_labels_past_the_head(
        tree_past_the_head, tmp_path):
    """``--data_dir`` with more classes than the head: ``--debug_nans``
    raises at step 0, naming the loss; without it the run logs NaN losses,
    evaluates and finishes, as lbt_tpu's does."""
    argv = ["--model", "CIFAR10_Resnet20", "--noise_mode", "hash",
            "--device", "cpu", "--batch_size", "8", "--n_epoch", "1",
            "--log_every", "1", "--data_dir", str(tree_past_the_head)]
    with pytest.raises(FloatingPointError,
                       match="nan\\) in loss after train step 0"):
        main(argv + ["--debug_nans", "--exp_path", str(tmp_path / "on")])
    tr = main(argv + ["--exp_path", str(tmp_path / "off")])
    assert tr.step == 2
    rows = [json.loads(r) for r in
            (tmp_path / "off" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 2 and all(math.isnan(v) for v in losses)
    assert any("test/loss" in r for r in rows)
