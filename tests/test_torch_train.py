"""The port's training path held against lbt_tpu on the CPU: the key
chain, the controllers, the cotangent barrier, the integer backward of
qmatmul / qconv2d, the config and converter, and three train steps of a
CIFAR ResNet-8 under ``QuantConfig.uniform(8, noise_mode='hash')``.

Integer results (keys, codes, exponents, contractions under 2**24) are
compared bitwise.  The train step is compared at the tolerances stated on
``test_train_step_matches_lbt_tpu``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbt_tpu.config as jconfig
from lbt_tpu.dfxp.barrier import HOLD_STATS as JHOLD_STATS
from lbt_tpu.dfxp.barrier import grad_quant_barrier as jbarrier
from lbt_tpu.models import cifar10_resnet as jax_resnet
from lbt_tpu.ops import qops as jops
from lbt_tpu.train.optim import momentum_init as jmomentum_init
from lbt_tpu.train.optim import piecewise_lr as jpiecewise_lr
from lbt_tpu.train.step import make_train_step as jmake_train_step
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.dfxp import quantize as tq
from lbt_tpu_torch.dfxp.barrier import (HOLD_STATS, grad_quant_barrier,
                                        make_sink)
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.nn import core
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.ops import qops
from lbt_tpu_torch.train.optim import momentum_init, piecewise_lr
from lbt_tpu_torch.train.step import forward_backward, make_train_step

pytest_plugins = ["torch_suite"]

jq = importlib.import_module("lbt_tpu.dfxp.quantize")


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_fold_in_matches_jax(seed):
    base = jax.random.key(seed, impl="threefry2x32")
    np.testing.assert_array_equal(keys.base_key(seed), _kd(base))
    for data in (0, 1, 5, 1000, 2 ** 31 + 3, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            keys.fold_in(keys.base_key(seed), data),
            _kd(jax.random.fold_in(base, np.uint32(data))))


def test_site_keys_match_layer_keys():
    """One step's table of site keys equals ``Ctx.layer_key``'s chain."""
    from lbt_tpu.nn.core import Ctx as JCtx
    step_key = jax.random.fold_in(jax.random.key(3), 11)
    jctx = JCtx(train=True, key=step_key)
    ctx = Ctx(train=True, key=keys.fold_in(keys.base_key(3), 11))
    for uid in (0, 1, 17, 52):
        for site in range(5):
            assert ctx.layer_key(uid, site) == tuple(
                int(v) for v in _kd(jctx.layer_key(uid, site)))


# ---------------------------------------------------------------------------
# controllers
# ---------------------------------------------------------------------------


def _staged_rates(ctx):
    """The rates of the controller step last staged on ``ctx``."""
    site = ctx._ctrl[-1]
    return core._rates([site], site.stat[None])[0]


@pytest.mark.parametrize("bits", [8, 9])
@pytest.mark.parametrize("target", [0.0, 0.01])
def test_overflow_stats_and_update_exponent_match_lbt_tpu(bits, target):
    """A site's staged statistics, as rates, are ``lbt_tpu``'s
    ``overflow_stats`` of its tensor, and the committed exponent is
    ``lbt_tpu``'s ``update_exponent`` of them; at a zero target K1's
    ``[min, max]`` stages the same rates."""
    from lbt_tpu_torch.nn.layers import Dense
    cfg = tconfig.QuantConfig.uniform(8, target_overflow_rate=target)
    layer = core.finalize(Dense("d", cfg, 2, 2))
    rng = np.random.default_rng(bits)
    for scale in (1e-6, 0.01, 1.0, 50.0, 1e30):
        x = (rng.normal(0, 1, (6, 7, 5)) * scale).astype(np.float32)
        for exp in (bits - 1, 3, 0, -20, jq.EXP_MIN, jq.EXP_MIN + 1):
            want = np.asarray(jq.overflow_stats(jnp.asarray(x), bits,
                                                jnp.int32(exp), target))
            layer.exp("x").fill_(exp)
            ctx = Ctx(train=True)
            layer._ctrl(ctx, "x", bits, torch.from_numpy(x))
            np.testing.assert_array_equal(_staged_rates(ctx).numpy(), want)
            ctx.commit()
            assert layer.exp("x").dtype == torch.int32
            assert int(layer.exp("x")) == int(jq.update_exponent(
                jnp.int32(exp), jnp.asarray(want), bits, target))
            if target == 0.0:  # K1's min / max gives the same indicators
                _, _, mm = tq.quantize_int(torch.from_numpy(x), bits, exp,
                                           stats=True)
                layer._ctrl(ctx, "x", bits, torch.from_numpy(x), mm)
                np.testing.assert_array_equal(_staged_rates(ctx).numpy(),
                                              want)


class _OneRank:
    """A group of one rank (``parallel.multihost.Group``'s collectives)
    that records each all-reduce: its op, kind and input."""
    world = 1

    def __init__(self):
        self.calls = []

    def all_reduce(self, t, op="sum", kind="reduce"):
        self.calls.append((op, kind, t.detach().clone()))
        return t.detach().clone()

    def mean(self, t, kind="reduce"):
        return self.all_reduce(t, kind=kind) / self.world


@pytest.mark.parametrize("target", [0.0, 0.01])
def test_batched_controller_step_matches_site_by_site(target):
    """Forward sites of 4, 8 and 9 bits, some sharded over a model group
    of one rank, some measured by K1's ``[min, max]``, staged through
    ``Layer._ctrl`` under a data group of one rank and committed in one
    batched step: each exponent is ``lbt_tpu``'s ``update_exponent``,
    site by site, of ``overflow_stats`` of the site's tensor.  The model
    group sees one all-reduce of the sharded rows (MAX of ``[-min, max]``
    at a zero target, SUM of the counts otherwise), the data group one
    mean of every site's rates, the unsharded sites' first in staging
    order, then the sharded ones'."""
    from lbt_tpu_torch.nn.layers import Dense
    from lbt_tpu_torch.parallel.mesh import Shard
    cfg = tconfig.QuantConfig.uniform(8, target_overflow_rate=target)
    model_group, data_group = _OneRank(), _OneRank()
    ctx = Ctx(train=True, dist=data_group)
    rng = np.random.default_rng(7)
    want, rows = [], ([], [])
    for i in range(15):
        layer = core.finalize(Dense(f"d{i}", cfg, 2, 2))
        bits, sharded = (4, 8, 9)[i % 3], i % 4 == 1
        e = (bits - 1, 2, 0, -3, jq.EXP_MIN)[i % 5]
        layer.exp("x").fill_(e)
        x = (rng.normal(0, 1, (3, 8))
             * 2.0 ** rng.integers(-8, 10)).astype(np.float32)
        if i % 5 in (1, 3):  # the minimum decides
            x = -np.abs(x)
        mm = (tq.quantize_int(torch.from_numpy(x), bits, e, stats=True)[2]
              if i % 3 == 0 else None)
        layer._ctrl(ctx, "x", bits, torch.from_numpy(x), mm,
                    shard=Shard(model_group, 0, 8, 8) if sharded else None)
        rates = np.asarray(jq.overflow_stats(jnp.asarray(x), bits,
                                             jnp.int32(e), target))
        rows[sharded].append(rates)
        want.append((layer, e, int(jq.update_exponent(
            jnp.int32(e), jnp.asarray(rates), bits, target))))
    ctx.commit()
    assert [int(layer.exp("x")) for layer, _, _ in want] == [
        w for _, _, w in want]
    assert {-1, 1} <= {int(np.sign(w - e)) for _, e, w in want}
    ((op, kind, stats),) = model_group.calls
    assert (op, kind, stats.shape) == ("max" if target == 0.0 else "sum",
                                       "stats", (len(rows[1]), 2))
    ((op, kind, rates),) = data_group.calls
    assert (op, kind) == ("sum", "stats")
    np.testing.assert_array_equal(rates.numpy(), np.stack(rows[0] + rows[1]))


# ---------------------------------------------------------------------------
# the cotangent barrier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("exp", [-3, 2, jq.EXP_MIN])
def test_barrier_matches_lbt_tpu(exp, gate):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3, 6, 6, 8)).astype(np.float32)
    g = (rng.normal(0, 1, x.shape) * 2.0 ** (exp - 4)).astype(np.float32)
    key = jax.random.fold_in(jax.random.key(1), 9)

    def f(x, sink):
        y = jbarrier(x, 8, jnp.int32(exp), sink, key, stochastic=True,
                     backend="xla_hash", gate=gate)
        return jnp.vdot(y, jnp.asarray(g))

    want_gx, want_sink = jax.grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.zeros((2,), jnp.float32))

    tx = torch.from_numpy(x).requires_grad_()
    sink = make_sink()
    y = grad_quant_barrier(tx, 8, torch.tensor(exp, dtype=torch.int32),
                           sink, tuple(int(v) for v in _kd(key)),
                           stochastic=True, backend="xla_hash", gate=gate)
    assert torch.equal(y.detach(), tx.detach())
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_gx))
    np.testing.assert_array_equal(sink.grad.numpy(), np.asarray(want_sink))


# ---------------------------------------------------------------------------
# qmatmul / qconv2d backward
# ---------------------------------------------------------------------------

# (x shape, kernel HWIO, stride): ResNet-20's conv classes at small size
BWD_CLASSES = {
    "3x3s1": ((2, 8, 8, 16), (3, 3, 16, 16), 1),
    "3x3s2": ((2, 8, 8, 16), (3, 3, 16, 32), 2),
    "1x1s2": ((2, 8, 8, 16), (1, 1, 16, 32), 2),
    "stem": ((2, 8, 8, 3), (3, 3, 3, 16), 1),
    "3x3s2_odd": ((2, 7, 9, 4), (3, 3, 4, 8), 2),
}


def _grid_cotangent(rng, shape, exp_g):
    return (rng.integers(-128, 128, shape) / 2.0 ** (7 - exp_g)).astype(
        np.float32)


@pytest.mark.parametrize("bits_x", [8, 9])
@pytest.mark.parametrize("cls", sorted(BWD_CLASSES))
def test_qconv2d_backward_matches_lbt_tpu(cls, bits_x):
    xshape, wshape, s = BWD_CLASSES[cls]
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, xshape).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, wshape).astype(np.float32)
    exp_x, exp_w, exp_g = 1, 0, -3
    kw = dict(strides=(s, s), padding="SAME", bits_x=bits_x, bits_w=8)

    def f(x, w):
        return jops.qconv2d(x, w, jnp.int32(exp_x), jnp.int32(exp_w),
                            jnp.int32(exp_g), bits_g=8, engine="int8", **kw)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    g = _grid_cotangent(rng, y.shape, exp_g)
    want_dx, want_dw = vjp(jnp.asarray(g))
    # lbt_tpu's dW of 9-bit codes sums in f32: exact only below 2**24.
    # A dW element sums |x code| * |g code| <= 128 |x code| over part of
    # one input channel.
    xc = np.abs(np.asarray(jq.quantize_int(jnp.asarray(x), bits_x,
                                           jnp.int32(exp_x))[0], np.float64))
    assert xc.sum(axis=(0, 1, 2)).max() * 128 < 2 ** 24

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = qops.qconv2d(tx, tw, exp_x, exp_w, exp_g=exp_g, bits_g=8, **kw)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_dx))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(want_dw))


@pytest.mark.parametrize("exps", [(2, 1, -2), (0, -1, -9)])
def test_qmatmul_backward_matches_lbt_tpu(exps):
    exp_x, exp_w, exp_g = exps
    rng = np.random.default_rng(13)
    x = rng.normal(0, 1, (4, 64)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (64, 10)).astype(np.float32)

    def f(x, w):
        return jops.qmatmul(x, w, jnp.int32(exp_x), jnp.int32(exp_w),
                            jnp.int32(exp_g), bits_x=8, bits_w=8, bits_g=8,
                            engine="int8")

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    g = _grid_cotangent(rng, y.shape, exp_g)
    want_dx, want_dw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = qops.qmatmul(tx, tw, exp_x, exp_w, bits_x=8, bits_w=8, exp_g=exp_g,
                      bits_g=8)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_dx))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(want_dw))


def test_dilate_pad_crops_negative_pads():
    g = torch.arange(2 * 3 * 3 * 1).view(2, 3, 3, 1)
    out = qops.dilate_pad(g, (2, 2), ((1, -1), (0, 2)))
    assert out.shape == (2, 5, 7, 1)
    assert torch.equal(out[:, 1::2, 0:5:2], g[:, :2])
    assert out[:, 0].abs().sum() == 0 and out[:, :, 5:].abs().sum() == 0


# ---------------------------------------------------------------------------
# config, converter, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["QuantConfig", "TrainConfig"])
def test_config_matches_lbt_tpu(name):
    mine, theirs = getattr(tconfig, name), getattr(jconfig, name)
    assert ([(f.name, f.default) for f in dataclasses.fields(mine)]
            == [(f.name, f.default) for f in dataclasses.fields(theirs)])
    if name == "QuantConfig":
        for kw in ({}, {"noise_mode": "hash"}, {"conv_act_extra": 0}):
            assert (dataclasses.asdict(mine.uniform(8, **kw))
                    == dataclasses.asdict(theirs.uniform(8, **kw)))
        assert (dataclasses.asdict(mine.uniform(32))
                == dataclasses.asdict(theirs.uniform(32)))
        for bad in ({"bits_w": 0}, {"engine": "x"}, {"noise_mode": "x"},
                    {"range_update_every": 0}, {"initial_exponent_g": 99}):
            with pytest.raises(ValueError):
                mine(**bad)
        assert mine(conv9_split=True).quant_backend == "xla"
        assert cifar10_resnet(mine(conv9_split=True), 8).cfg.conv9_split


def _jax_trees(depth, cfg, seed=0, wd=0.0):
    jm = jax_resnet(cfg, depth, weight_decay=wd)
    params, qstate = jm.init(jax.random.key(seed))
    return jm, params, qstate


def test_converter_round_trip():
    cfg = jconfig.QuantConfig.uniform(8)
    _, params, qstate = _jax_trees(8, cfg)
    params, qstate = (jax.tree.map(np.asarray, t) for t in (params, qstate))
    rng = np.random.default_rng(0)
    velocity = jax.tree.map(
        lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
    model, vel = convert.from_jax_numpy(cifar10_resnet(cfg, 8), params,
                                        qstate, velocity)
    back = convert.to_jax_numpy(model, vel)
    for want, got in zip((params, qstate, velocity), back):
        assert (jax.tree.structure(want) == jax.tree.structure(got))
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    p2, q2, v2 = convert.to_jax_numpy(model)
    assert v2 is None


def test_decay_tree_matches_lbt_tpu():
    cfg = jconfig.QuantConfig.uniform(8)
    jm, _, _ = _jax_trees(8, cfg, wd=3e-4)
    model = cifar10_resnet(cfg, 8, weight_decay=3e-4)
    assert model.decay_tree() == jm.decay_tree()
    named = dict(model.net.named_parameters())
    assert {k for k, d in model.decays() if d} == {
        k for k in named if k.endswith((".W", ".gamma"))}


def test_converter_velocity_mismatch_raises():
    cfg = jconfig.QuantConfig.uniform(8)
    _, params, qstate = _jax_trees(8, cfg)
    velocity = jax.tree.map(np.zeros_like, params)
    bad = dict(velocity)
    del bad["softmax"]
    with pytest.raises(ValueError, match="missing"):
        convert.from_jax_numpy(cifar10_resnet(cfg, 8), params, qstate, bad)
    bad = dict(velocity)
    bad["softmax"] = {"W": np.zeros((64, 9), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_numpy(cifar10_resnet(cfg, 8), params, qstate, bad)
    model = cifar10_resnet(cfg, 8)
    with pytest.raises(ValueError, match="unexpected"):
        convert.to_jax_numpy(model, {"nope": torch.zeros(1)})


def test_piecewise_lr_matches_lbt_tpu():
    for epoch in (0, 1, 4, 79, 80, 121, 150):
        for warm in (0, 5):
            assert piecewise_lr(0.1, 0.1, (80, 120, 140), epoch, warm) == \
                jpiecewise_lr(0.1, 0.1, (80, 120, 140), epoch, warm)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

N_STEPS = 3
BATCH = 4
TOL = dict(rtol=1e-5, atol=1e-5)
LSB_SHARE = 1e-4


def _lsb(bits, exp):
    return 2.0 ** (int(exp) - (bits - 1))


def _compare_floats(got, want, lsb, path):
    """At rtol = atol = 1e-5, except at most ``LSB_SHARE`` of the leaf's
    elements, which may differ by up to one LSB of the leaf's site grid
    (a stochastic code flipped by a one-ulp BN difference upstream)."""
    d = np.abs(got.astype(np.float64) - want)
    off = d > TOL["atol"] + TOL["rtol"] * np.abs(want)
    assert off.sum() <= int(LSB_SHARE * got.size), (path, off.sum(), d.max())
    assert (d[off] <= lsb).all(), (path, d.max(), lsb)


def _compare_trees(got, want, lsb_of, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _compare_trees(got[k], want[k], lsb_of, f"{path}/{k}")
        return
    want = np.asarray(want)
    if want.dtype == np.int32:
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        _compare_floats(got, want, lsb_of(path), path)


# XLA on the CPU computes a bf16 contraction in f32 and, allowed excess
# precision, drops the rounding of its output to bf16, which the TPU, the
# card and the port keep; this compiler option keeps it (ROADMAP queue 3)
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def resnet_pair(cfg, depth=8):
    """``lbt_tpu``'s CIFAR ResNet under ``cfg`` and the port's, the port's
    initialized from a seed (lbt_tpu's own init runs op by op: seconds a
    model; :func:`compare_train_steps` carries these weights over)."""
    wd = jconfig.TrainConfig().weight_decay
    return (jax_resnet(cfg, depth, weight_decay=wd),
            cifar10_resnet(cfg, depth, weight_decay=wd).init(
                torch.Generator().manual_seed(0)))


def compare_train_steps(jm, model, batch_shape=(BATCH, 32, 32, 3),
                        n_classes=10, n_steps=N_STEPS, check_state=None):
    """``n_steps`` steps of ``model`` (the port's, initialized) and ``jm``
    (lbt_tpu's twin) from the same converted weights, base key (of
    ``model.cfg.noise_impl``) and data,
    through the port's ``make_train_step`` and ``lbt_tpu``'s, jitted
    without excess precision, compared after every step;
    ``check_state(port qstate, lbt_tpu qstate)`` adds a check of its own.

    Tolerances: losses at rtol 1e-5; accuracies and exponents bitwise;
    params, velocity and BN state at rtol = atol = 1e-5, except at most
    1e-4 of each leaf's elements, which may differ by one LSB of that
    leaf's grid (the site's width under ``model.cfg``) at the current
    exponent.  The BN moments are exact code sums in the port and f32
    reductions in lbt_tpu, so a stochastic code may flip by one."""
    tc = jconfig.TrainConfig()
    cfg = model.cfg
    bits_of = {"W": cfg.bits_w, "b": cfg.bits_b, "gamma": cfg.bits_b,
               "beta": cfg.bits_b}
    params, qstate, _ = convert.to_jax_numpy(model)
    velocity = jmomentum_init(params)
    vel = momentum_init(dict(model.net.named_parameters()))
    jstep = jax.jit(jmake_train_step(jm, tc, jit=False),
                    compiler_options=NO_EXCESS_PRECISION)
    step = make_train_step(model, tconfig.TrainConfig())
    rng = np.random.default_rng(0)
    jkey = jax.random.key(7, impl=cfg.noise_impl)
    for s in range(n_steps):
        x = rng.normal(0, 1, batch_shape).astype(np.float32)
        y = rng.integers(0, n_classes, (batch_shape[0],)).astype(np.int32)
        params, qstate, velocity, jmet = jstep(
            params, qstate, velocity, jnp.asarray(x), jnp.asarray(y), s,
            tc.lr, jkey)
        met = step(model, vel, torch.from_numpy(x), torch.from_numpy(y), s,
                   tc.lr, keys.base_key(7, cfg.noise_impl))
        np.testing.assert_allclose(met["loss"].item(),
                                   float(jmet["loss"]), rtol=1e-5)
        assert met["accuracy"].item() == float(jmet["accuracy"])
        p, q, v = convert.to_jax_numpy(model, vel)
        jq_np = jax.tree.map(np.asarray, qstate)

        def lsb_of(path, q=jq_np):
            node = q
            parts = path.strip("/").split("/")
            for part in parts[:-1]:
                node = node[part]
            exps = node.get("exp", {}) if isinstance(node, dict) else {}
            site = {"W": "w", "b": "b", "gamma": "gamma",
                    "beta": "beta"}.get(parts[-1], "x")
            return _lsb(bits_of.get(parts[-1], 8), exps.get(site, 2))

        _compare_trees(q, jq_np, lambda path: _lsb(8, 2))
        _compare_trees(p, jax.tree.map(np.asarray, params), lsb_of)
        _compare_trees(v, jax.tree.map(np.asarray, velocity), lsb_of)
        if check_state is not None:
            check_state(q, jq_np)


def test_train_step_matches_lbt_tpu():
    """Three steps of ResNet-8 under uniform(8, noise_mode='hash') against
    lbt_tpu's jitted ``make_train_step``, at the tolerances of
    :func:`compare_train_steps`."""
    compare_train_steps(*resnet_pair(
        jconfig.QuantConfig.uniform(8, noise_mode="hash")))


def test_layer_reached_twice_refuses_its_sink():
    """Two calls of one layer in one step would add two cotangents'
    statistics in its sink: the second call raises instead."""
    from lbt_tpu_torch.nn.core import finalize, make_sinks
    from lbt_tpu_torch.nn.layers import Dense
    cfg = tconfig.QuantConfig.uniform(8, noise_mode="hash")
    layer = finalize(Dense("d", cfg, 4, 4))
    ctx = Ctx(train=True, key=keys.base_key(0), sinks=make_sinks(layer))
    x = torch.ones(2, 4)
    layer(x, ctx)
    with pytest.raises(RuntimeError, match="reached twice"):
        layer(x, ctx)


def test_cadence_gates_the_controllers():
    """``range_update_every=2`` without warmup: step 1 holds every
    exponent (forward sites and, through the hold sentinel, gradient
    sites) while the BN statistics still move; step 2 runs them."""
    cfg = tconfig.QuantConfig.uniform(8, noise_mode="hash",
                                      range_update_every=2,
                                      range_update_warmup_steps=0)
    model = cifar10_resnet(cfg, 8).init(torch.Generator().manual_seed(0))
    vel = momentum_init(dict(model.net.named_parameters()))
    step = make_train_step(model, tconfig.TrainConfig())
    rng = np.random.default_rng(1)

    def run(s):
        x = torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 3)).astype(
            np.float32))
        step(model, vel, x, torch.tensor([1, 2]), s, 0.01, keys.base_key(0))

    def exps():
        return {k: b.clone() for k, b in model.net.named_buffers()
                if k.rsplit(".", 1)[-1].startswith("exp_")}

    run(0)
    before = exps()
    mean0 = model.net.layers[1].layers[0].mean.clone()
    run(1)
    assert all(torch.equal(before[k], v) for k, v in exps().items())
    assert not torch.equal(mean0, model.net.layers[1].layers[0].mean)
    run(2)
    assert any(not torch.equal(before[k], v) for k, v in exps().items())


def _grad_exps(model):
    """Each gradient-site exponent buffer of ``model``, by layer uid."""
    return {layer.uid: layer.exp("grad") for layer in core.walk(model.net)
            if layer.has_grad_sink()}


def _absorb_site_by_site(model):
    """``model.absorb_sinks`` as every site once stepped: each through
    ``update_exponent`` on its sink's statistics (``HOLD_STATS`` where a
    gated-off barrier wrote them)."""
    def absorb(stats):
        for layer in core.walk(model.net):
            if layer.has_grad_sink() and layer.uid in stats:
                exp = layer.exp("grad")
                exp.copy_(tq.update_exponent(
                    exp, stats[layer.uid], layer.cfg.bits_g,
                    layer.cfg.target_overflow_rate))
    return absorb


@pytest.mark.parametrize("target", [0.0, 0.01])
def test_cadence_hold_matches_update_exponent(target):
    """Four steps of ResNet-8 at ``range_update_every=2`` without warmup,
    from step 1 (gated off first) and ``initial_exponent_g=20``, above
    ``bits_g - 1``: the batched step leaves every exponent, parameter,
    BN statistic and velocity bitwise where stepping each site through
    ``update_exponent`` on its sink's statistics leaves them, after
    every step; on the first step each gradient exponent is ``lbt_tpu``'s
    ``update_exponent`` of 20 on its ``HOLD_STATS``: clamped to 7."""
    cfg = tconfig.QuantConfig.uniform(
        8, noise_mode="hash", range_update_every=2,
        range_update_warmup_steps=0, initial_exponent_g=20,
        target_overflow_rate=target)
    twins = [cifar10_resnet(cfg, 8).init(torch.Generator().manual_seed(0))
             for _ in range(2)]
    twins[1].absorb_sinks = _absorb_site_by_site(twins[1])
    vels = [momentum_init(dict(m.net.named_parameters())) for m in twins]
    steps = [make_train_step(m, tconfig.TrainConfig()) for m in twins]
    rng = np.random.default_rng(2)
    hold = jnp.asarray(JHOLD_STATS, jnp.float32)
    for s in range(1, 5):
        x = torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 3)).astype(
            np.float32))
        before = {u: int(e) for u, e in _grad_exps(twins[0]).items()}
        for m, v, step in zip(twins, vels, steps):
            step(m, v, x, torch.tensor([3, 5]), s, 0.01, keys.base_key(0))
        got, want = (m.net.state_dict() for m in twins)
        for k in want:
            assert torch.equal(got[k], want[k]), (s, k)
        for k in vels[1]:
            assert torch.equal(vels[0][k], vels[1][k]), (s, k)
        if s == 1:
            for u, e in _grad_exps(twins[0]).items():
                assert int(e) == int(jq.update_exponent(
                    jnp.int32(before[u]), hold, 8, target)) == 7


@pytest.mark.parametrize("target", [-0.5, 0.0, 0.01, 0.99999999, 1.0, 2.0])
def test_batched_hold_matches_lbt_tpu(target):
    """The batched step of ``absorb_sinks`` on the ``HOLD_STATS`` rows a
    gated-off barrier makes (``hold_stats``) gives each site ``lbt_tpu``'s
    ``update_exponent`` on ``HOLD_STATS``, in one batch of mixed
    ``bits_g``, at every exponent and at targets that widen (below 0),
    hold, and tighten (1 and above, 0.99999999 among them: it is 1 in
    f32)."""
    from lbt_tpu_torch.dfxp.barrier import hold_stats
    from lbt_tpu_torch.nn.layers import Dense
    sites = []
    for bits in (4, 8):
        cfg = dataclasses.replace(tconfig.QuantConfig.uniform(
            8, target_overflow_rate=target), bits_g=bits)
        for e in (31, bits, bits - 1, 0, jq.EXP_MIN, jq.EXP_MIN - 5):
            layer = Dense(f"d{len(sites)}", cfg, 2, 2)
            sites.append((layer, e, bits))
    net = core.finalize(core.Sequential("net", [s[0] for s in sites]))
    for layer, e, _ in sites:
        layer.exp("grad").fill_(e)
    net.absorb_sinks({layer.uid: hold_stats("cpu") for layer, _, _ in sites})
    hold = jnp.asarray(JHOLD_STATS, jnp.float32)
    for layer, e, bits in sites:
        assert layer.exp("grad").dtype == torch.int32
        assert int(layer.exp("grad")) == int(jq.update_exponent(
            jnp.int32(e), hold, bits, target)), (e, bits)


def test_gated_off_backward_holds_on_the_device(monkeypatch):
    """With the controllers gated off, the backward builds no tensor from
    Python data (on a card that is a pageable copy and a wait: here
    ``torch.tensor`` raises inside ``backward``), nor, gated on or off,
    does the commit's or ``absorb_sinks``' batched step; the sink a
    cotangent reached (d1) reads ``HOLD_STATS``, on which the step holds
    its exponent, and the one none reached (d0, frozen) tightens on zero
    statistics, as ``lbt_tpu``'s zero sink cotangent does.  Gated on, d1
    reads its cotangent's statistics and d0 tightens again."""
    from lbt_tpu_torch.nn.layers import Dense, ReLU
    from lbt_tpu_torch.nn.model import Model
    cfg = tconfig.QuantConfig.uniform(8, noise_mode="hash")
    model = Model("m", [Dense("d0", cfg, 6, 8), ReLU(),
                        Dense("d1", cfg, 8, 3)], (6,), 3, cfg).init(
        torch.Generator().manual_seed(0))
    d0, d1 = model.net.layers[0], model.net.layers[2]
    for p in d0.parameters():
        p.requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (4, 6)).astype(np.float32))
    y = torch.tensor([0, 1, 2, 0])

    def no_tensor(*args, **kwargs):
        raise AssertionError("a tensor from Python data in the step")

    def guarded(fn):
        def call(*args, **kwargs):
            with monkeypatch.context() as mp:
                mp.setattr(torch, "tensor", no_tensor)
                return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(Ctx, "commit", guarded(Ctx.commit))
    zero = jnp.zeros((2,), jnp.float32)
    hold = jnp.asarray(JHOLD_STATS, jnp.float32)
    for gate in (False, True):
        ctx = Ctx(train=True, key=keys.base_key(0), update_gate=gate,
                  sinks=model.make_sinks(), n_uids=model.num_layers())
        e0, e1 = int(d0.exp("grad")), int(d1.exp("grad"))
        with monkeypatch.context() as mp:
            if not gate:
                mp.setattr(torch.Tensor, "backward",
                           guarded(torch.Tensor.backward))
            _, _, stats = forward_backward(model, ctx, x, y)
        assert ctx.sinks[d0.uid].grad is None
        assert set(stats) == {d0.uid, d1.uid}
        assert stats[d1.uid] is ctx.sinks[d1.uid].grad
        guarded(model.absorb_sinks)(stats)
        assert int(d0.exp("grad")) == int(jq.update_exponent(
            jnp.int32(e0), zero, 8, 0.0)) == e0 - 1
        want = hold if not gate else jnp.asarray(stats[d1.uid].numpy())
        if not gate:
            assert stats[d1.uid].tolist() == list(HOLD_STATS)
        assert int(d1.exp("grad")) == int(jq.update_exponent(
            jnp.int32(e1), want, 8, 0.0))
        if not gate:
            assert int(d1.exp("grad")) == e1
