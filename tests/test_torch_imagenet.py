"""The ImageNet ResNets of the port held against lbt_tpu on the CPU, under
the bench headline's configuration (``bench.py``: ``uniform(8,
engine='int8', noise_mode='hash1')`` with ``fused_bn``,
``range_update_every=8``, bf16 carriers, ``conv_act_extra=0``):

* three train steps of ``imagenet_resnet(50, num_classes=10,
  image_size=32)`` at batch 4 against lbt_tpu's ``make_train_step``, with
  ``range_update_warmup_steps=1`` so steps 1 and 2 run with the
  controllers gated off (bf16 carriers here, f32 in
  ``test_torch_fused_bn.py``);
* one serving forward of ``imagenet_resnet(18, image_size=64)``;
* the cold-start exponent knob, the converter both ways with velocity,
  the CLI's headline flags, and ``--remat_bn`` / ``--bn_residual_q16``
  on the headline, where neither changes a bit.

Tolerances are stated on each test.  lbt_tpu compiles the whole train
step with both branches of its controller cadence; that compile takes
most of this file's time.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbt_tpu import config as jconfig
from lbt_tpu.models import imagenet_resnet as jimagenet_resnet
from lbt_tpu.nn.core import Ctx as JCtx
from lbt_tpu.nn.core import make_sinks as jmake_sinks
from lbt_tpu.train.optim import momentum_init as jmomentum_init
from lbt_tpu.train.step import make_train_step as jmake_train_step
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.main import build_parser, quant_config
from lbt_tpu_torch.models import build_model, imagenet_resnet
from lbt_tpu_torch.models.zoo import MODEL_DATASET
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.train.step import make_train_step

from test_torch_train import _compare_trees, _lsb

pytest_plugins = ["torch_suite"]

N_STEPS = 3
BATCH = 4


def headline(act_dtype, module=jconfig, **kw):
    """The bench headline's QuantConfig (``bench.py:301-304``) at
    ``act_dtype``, from ``module``'s ``QuantConfig`` (lbt_tpu's or the
    port's)."""
    return dataclasses.replace(
        module.QuantConfig.uniform(8, engine="int8", noise_mode="hash1"),
        fused_bn=True, range_update_every=8, act_dtype=act_dtype,
        conv_act_extra=0, **kw)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _exps_equal(got, want):
    got = dict(_leaves(got))
    for path, w in _leaves(want):
        if w.dtype == np.int32:
            np.testing.assert_array_equal(got[path], w, err_msg=path)


def _lsb_of(qstate):
    """One LSB of a parameter leaf's 8-bit grid at its site's exponent."""
    def lsb(path):
        node = qstate
        parts = path.strip("/").split("/")
        for part in parts[:-1]:
            node = node[part]
        site = {"W": "w", "b": "b", "gamma": "gamma",
                "beta": "beta"}.get(parts[-1], "x")
        return _lsb(8, node.get("exp", {}).get(site, 2))
    return lsb


# the layers a bf16 carrier's cascade of code flips reaches at step 0 (see
# resnet50_steps_match_lbt_tpu)
CASCADE = ("conv1/", "conv1-bn/", "stage1-")
CASCADE_REL_L2 = 0.1


def resnet50_steps_match_lbt_tpu(act_dtype: str):
    """Three steps of ResNet-50 (batch 4, 32x32, 10 classes) from the
    same converted weights, base key and data as lbt_tpu's jitted
    ``make_train_step``, the controllers on at step 0 and gated off at
    steps 1-2 (their exponents hold).

    Held: exponents bitwise after every step; after step 0, the loss at
    rtol 1e-5, and under f32 carriers params, velocity and BN state as
    ``test_torch_train.py`` holds them (rtol = atol = 1e-5, at most 1e-4
    of a leaf one LSB off); under bf16 carriers BN state and every
    parameter and velocity leaf of stages 2-4 and the head at rtol 1e-3,
    atol 1e-5, and those of the stem and stage 1 within a relative L2
    distance of ``CASCADE_REL_L2``.

    Not held (ROADMAP queue 3): the floats of steps 1-2.  lbt_tpu's XLA
    evaluates the fused BN's ``(xq - mean) * (gq / sqrt(var + eps)) + bq``
    with other roundings (a third of the stem BN's outputs one ulp apart
    after a step), and an ulp can flip a stochastic code at the next
    site; at 32x32 stage 4 normalizes 4 values a channel, where one
    flipped code moves the normalized values by O(1), so the logits of
    step 1 part by units.  Under bf16 carriers the BN backward's f32 sums
    (summed in another order) cross a bfloat16 rounding now and then, and
    a bf16 ulp flips a stochastic 8-bit cotangent code with probability
    up to one half; from stage 2 down the flips cascade, so at step 0 the
    stem's and stage 1's gradients differ by about 1% (97% of the stem's
    weights beyond rtol 1e-3)."""
    cfg = headline(act_dtype, range_update_warmup_steps=1)
    tcfg = headline(act_dtype, tconfig, range_update_warmup_steps=1)
    tc = jconfig.TrainConfig()
    jm = jimagenet_resnet(cfg, 50, num_classes=10, image_size=32,
                          weight_decay=tc.weight_decay)
    params, qstate = jm.init(jax.random.key(0))
    velocity = jmomentum_init(params)
    model, vel = convert.from_jax_numpy(
        imagenet_resnet(tcfg, 50, num_classes=10, image_size=32,
                        weight_decay=tc.weight_decay),
        *(jax.tree.map(np.asarray, t) for t in (params, qstate, velocity)))
    assert model.decay_tree() == jm.decay_tree()
    jstep = jmake_train_step(jm, tc, jit=True, donate=False)
    step = make_train_step(model, tconfig.TrainConfig())
    rng = np.random.default_rng(0)
    jkey = jax.random.key(7)
    for s in range(N_STEPS):
        x = rng.normal(0, 1, (BATCH, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, (BATCH,)).astype(np.int32)
        params, qstate, velocity, jmet = jstep(
            params, qstate, velocity, jnp.asarray(x), jnp.asarray(y), s,
            tc.lr, jkey)
        met = step(model, vel, torch.from_numpy(x), torch.from_numpy(y), s,
                   tc.lr, keys.base_key(7))
        assert np.isfinite(met["loss"].item())
        p, q, v = convert.to_jax_numpy(model, vel)
        want = [jax.tree.map(np.asarray, t)
                for t in (params, qstate, velocity)]
        _exps_equal(q, want[1])
        if s:
            continue
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-5)
        if act_dtype == "f32":
            _compare_trees(q, want[1], lambda path: _lsb(8, 2))
            for got, w in ((p, want[0]), (v, want[2])):
                _compare_trees(got, w, _lsb_of(want[1]))
            continue
        for path, w in _leaves(want[1]):
            np.testing.assert_allclose(dict(_leaves(q))[path], w, rtol=1e-3,
                                       atol=1e-5, err_msg=path)
        for got, w in ((p, want[0]), (v, want[2])):
            got = dict(_leaves(got))
            for path, wl in _leaves(w):
                if path.startswith(CASCADE):
                    dist = (np.linalg.norm(got[path] - wl)
                            / np.linalg.norm(wl))
                    assert dist < CASCADE_REL_L2, (path, dist)
                else:
                    np.testing.assert_allclose(got[path], wl, rtol=1e-3,
                                               atol=1e-5, err_msg=path)


def test_resnet50_bf16_train_steps_match_lbt_tpu():
    resnet50_steps_match_lbt_tpu("bf16")


def test_resnet18_serving_matches_lbt_tpu():
    """One serving forward (running BN statistics, no key) of
    ``imagenet_resnet(18, num_classes=10, image_size=64)`` under the
    headline config: the 7x7/2 stem (pads (2, 3)), max pool 3x3/2 SAME,
    basic blocks, the head's bias.  Logits at rtol 1e-5 (atol 1e-6)."""
    cfg, tcfg = headline("bf16"), headline("bf16", tconfig)
    jm = jimagenet_resnet(cfg, 18, num_classes=10, image_size=64)
    params, qstate = jm.init(jax.random.key(2))
    rng = np.random.default_rng(3)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if key == "mean":
            return rng.normal(0, 0.3, a.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if key == "b":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    params, qstate = walk(params), walk(qstate)
    x = rng.normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    ctx = JCtx(train=False, key=None, update=False)
    want = np.asarray(jax.jit(lambda p, q, x: jm.apply(
        p, q, jmake_sinks(jm.net), x, ctx)[0])(params, qstate,
                                                 jnp.asarray(x))
        .astype(jnp.float32))
    model = build_model("Imagenet_Resnet18", tcfg, num_classes=10,
                        image_size=64)
    assert model.net.layers[0].strides == (2, 2)
    convert.from_jax_numpy(model, params, qstate)
    got = model.apply(torch.from_numpy(x), Ctx(train=False))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 10)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_initial_exponent_g_cold_start_knob():
    """``initial_exponent_g`` re-bases only the gradient sites' cold-start
    exponents of ``Imagenet_Resnet18``; every other site keeps 2, and the
    default keeps 2 everywhere (``tests/test_models.py``'s test, on the
    port)."""
    cfg = tconfig.QuantConfig.uniform(8, initial_exponent_g=-10)
    model = build_model("Imagenet_Resnet18", cfg, num_classes=10,
                        image_size=64).init(torch.Generator().manual_seed(0))
    n_grad = n_other = 0
    for name, buf in model.net.named_buffers():
        site = name.rsplit(".", 1)[-1]
        if not site.startswith("exp_"):
            continue
        if site == "exp_grad":
            assert buf.item() == -10, name
            n_grad += 1
        else:
            assert buf.item() == 2, name
            n_other += 1
    assert n_grad > 10 and n_other > 10
    model2 = build_model("Imagenet_Resnet18", tconfig.QuantConfig.uniform(8),
                         num_classes=10, image_size=64)
    assert all(b.item() == 2 for n, b in model2.net.named_buffers()
               if n.rsplit(".", 1)[-1].startswith("exp_"))


@pytest.mark.parametrize("act_dtype", ["f32", "bf16"])
def test_resnet50_converter_round_trip(act_dtype):
    """lbt_tpu's ResNet-50 trees (``FusedBatchNorm`` under ``fused``,
    bottlenecks, the head's bias) with a velocity tree into the port and
    back, bitwise, dtypes and structure included; a tree of the unfused BN
    raises."""
    cfg, tcfg = headline(act_dtype), headline(act_dtype, tconfig)
    jm = jimagenet_resnet(cfg, 50, num_classes=10, image_size=32)
    params, qstate = (jax.tree.map(np.asarray, t)
                      for t in jm.init(jax.random.key(1)))
    rng = np.random.default_rng(0)
    velocity = jax.tree.map(
        lambda a: rng.normal(0, 1, a.shape).astype(np.float32), params)
    model, vel = convert.from_jax_numpy(
        imagenet_resnet(tcfg, 50, num_classes=10, image_size=32), params,
        qstate, velocity)
    assert set(params["conv1-bn"]) == {"fused"}
    assert set(params["softmax"]) == {"W", "b"}
    for want, got in zip((params, qstate, velocity),
                         convert.to_jax_numpy(model, vel)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    unfused = dataclasses.replace(tcfg, fused_bn=False)
    with pytest.raises(ValueError, match="keys differ"):
        convert.from_jax_numpy(
            imagenet_resnet(unfused, 50, num_classes=10, image_size=32),
            params, qstate)


def test_cli_takes_the_headline_and_refuses_the_rest():
    """The headline's command line gives the headline's config, with
    ``--stem_s2d`` and ``--noise_mode prng`` too and with ``--remat_bn``
    and ``--bn_residual_q16`` (all refused before they were ported).
    Under the headline (fused BN, bf16 carriers) the two BN flags change
    no bit: 2 train steps of ``imagenet_resnet(18, image_size=32)`` at
    batch 2 with both equal the steps without, in every state tensor."""
    p = build_parser()
    argv = ["--model", "Imagenet_Resnet50", "--bits", "8", "--engine",
            "int8", "--noise_mode", "hash1", "--fused_bn",
            "--range_update_every", "8", "--act_dtype", "bf16",
            "--conv_act_extra", "0", "--batch_size", "128"]
    want = headline("bf16", tconfig)
    assert quant_config(p.parse_args(argv)) == want
    assert MODEL_DATASET["Imagenet_Resnet50"] == "imagenet"
    assert MODEL_DATASET["Imagenet_Resnet18"] == "imagenet"
    s2d = quant_config(p.parse_args(argv[:4] + ["--noise_mode", "prng",
                                                "--stem_s2d"]))
    assert s2d.stem_s2d and s2d.noise_mode == "prng"
    flagged = quant_config(p.parse_args(argv + ["--remat_bn",
                                                "--bn_residual_q16"]))
    assert flagged == dataclasses.replace(want, remat_bn=True,
                                          bn_residual_q16=True)
    rng = np.random.default_rng(2)
    batches = [(torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 3)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 10, (2,))))
        for _ in range(2)]
    states = []
    for cfg in (want, flagged):
        model = imagenet_resnet(cfg, 18, num_classes=10, image_size=32).init(
            torch.Generator().manual_seed(0))
        step = make_train_step(model, tconfig.TrainConfig())
        vel = {k: torch.zeros_like(v)
               for k, v in model.net.named_parameters()}
        losses = [step(model, vel, x, y, i, 0.01, keys.base_key(3))["loss"]
                  for i, (x, y) in enumerate(batches)]
        states.append((losses, model.net.state_dict(), vel))
    (l0, s0, v0), (l1, s1, v1) = states
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k in v0:
        assert torch.equal(v0[k], v1[k]), k
