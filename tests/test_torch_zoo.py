"""The port's model zoo held against lbt_tpu on the CPU: Dropout and SAME
AvgPool, every registry model's layer names and parameter shapes (and the
converter both ways), the serving forwards of the reference's four small
models, and three train steps each of LeNet / MNIST under main.py's
defaults (``prng`` noise, dropout), of a VGG-16-shaped sub-net under
``int4w-int8a`` and of ResNet-8 with the error-feedback gradient buffers.

Dropout masks and outputs are compared bitwise, AvgPool at rtol 1e-6, the
forwards at rtol = atol = 1e-5, the train steps at the tolerances of
``test_torch_train.compare_train_steps`` with the gradient buffers at
rtol = atol = 1e-6.  lbt_tpu's full VGG-16 step is not compiled here: the
full model is held by names and shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbt_tpu.config as jconfig
import lbt_tpu.models.zoo as jmodels
from lbt_tpu.nn import layers as jlayers
from lbt_tpu.nn.core import Ctx as JCtx
from lbt_tpu.nn.model import Model as JModel
from lbt_tpu.nn.norm import BatchNorm as JBatchNorm
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.main import build_parser, main, quant_config
from lbt_tpu_torch.models import (MODEL_DATASET, MODEL_REGISTRY, build_model,
                                  cifar10_resnet)
from lbt_tpu_torch.nn import layers as tlayers
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.nn.norm import BatchNorm
from test_torch_train import compare_train_steps

pytest_plugins = ["torch_suite"]

# benchmarks/vgg_bench.py's int4w-int8a: 4-bit weights, 8-bit biases, BN
# parameters and gradients, 9-bit conv activations
INT4W = dataclasses.replace(
    jconfig.QuantConfig.uniform(8, engine="int8", noise_mode="hash"),
    bits_w=4)


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key), np.uint32)


# ---------------------------------------------------------------------------
# Dropout and AvgPool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("keep", [0.5, 0.8])
def test_dropout_matches_lbt_tpu(keep, dtype):
    """Mask and output bitwise equal to lbt_tpu's ``Dropout`` at the same
    uid and step key, under f32 and bf16 carriers; the identity outside
    training and at keep 1."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(3).normal(0, 1, (4, 5, 6, 7)).astype(
        np.float32)
    key = jax.random.key(11)
    jl, tl = jlayers.Dropout(keep=keep), tlayers.Dropout(keep=keep)
    jl.uid = tl.uid = 9
    want, _ = jl.apply({}, {}, {}, jnp.asarray(x, jdt),
                       JCtx(train=True, key=key))
    xt = torch.from_numpy(x).to(tdt)
    got = tl(xt, Ctx(train=True, key=_kd(key)))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    mask = np.asarray(jax.random.bernoulli(
        jax.random.fold_in(jax.random.fold_in(key, 9), 4), keep, x.shape))
    np.testing.assert_array_equal(got.float().numpy() != 0, mask & (x != 0))
    assert tl(xt, Ctx(train=False)) is xt
    assert tlayers.Dropout(keep=1.0)(xt, Ctx(train=True, key=_kd(key))) is xt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", [((3, 3), (2, 2), "SAME"),
                                  ((2, 2), (1, 1), "SAME"),
                                  ((3, 3), (1, 1), "VALID")])
def test_avgpool_matches_lbt_tpu(case, dtype):
    """SAME (padded positions excluded from the divisor) and VALID average
    pooling at rtol 1e-6, f32 and bf16 carriers.  XLA on the CPU sums some
    padded windows in another order than row-major (column-major for a
    2x2 SAME window at stride 1): the f32 sums of values near 1 then part
    in the last bit, which a mean near zero magnifies in relative terms,
    so atol is 1e-7, about one ulp at 1."""
    ksize, strides, padding = case
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(4).normal(0, 1, (2, 7, 9, 3)).astype(
        np.float32)
    kw = dict(ksize=ksize, strides=strides, padding=padding)
    want, _ = jlayers.AvgPool(**kw).apply({}, {}, {}, jnp.asarray(x, jdt),
                                          JCtx(train=False))
    got = tlayers.AvgPool(**kw)(torch.from_numpy(x).to(tdt),
                                Ctx(train=False))
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _build_both(name, cfg, **kw):
    return (jmodels.build_model(name, cfg, **kw),
            build_model(name, cfg, **kw))


_REGISTRY_CASES = [(n, {}) for n in sorted(jmodels.MODEL_REGISTRY)] + [
    ("CIFAR10_Resnet20", {"gradient_buffer_batch": 8})]


@pytest.mark.parametrize("name,kw", _REGISTRY_CASES,
                         ids=[n + ("-gb" if kw else "")
                              for n, kw in _REGISTRY_CASES])
def test_registry_model_matches_lbt_tpu(name, kw):
    """Every ``lbt_tpu`` registry model: the same layer names, parameter
    and state shapes and dtypes (lbt_tpu's init traced, not run), decay
    tree and dataset; the converter carries the port's trees out and back
    in bit for bit."""
    cfg = jconfig.QuantConfig.uniform(8)
    jm, model = _build_both(name, cfg, weight_decay=3e-4, **kw)
    want = jax.eval_shape(jm.init, jax.random.key(0))
    params, qstate, _ = convert.to_jax_numpy(model)
    for w, g in zip(want, (params, qstate)):
        assert jax.tree.structure(w) == jax.tree.structure(g), name
        for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(g)):
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
    assert model.decay_tree() == jm.decay_tree()
    assert MODEL_DATASET[name] == jmodels.MODEL_DATASET[name]
    assert model.num_layers() == sum(1 for _ in _jax_walk(jm.net))

    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: rng.normal(0, 1, a.shape).astype(a.dtype), params)
    velocity = jax.tree.map(np.zeros_like, params)
    back = build_model(name, cfg, weight_decay=3e-4, **kw)
    back, vel = convert.from_jax_numpy(back, params, qstate, velocity)
    for a, b in zip(jax.tree.leaves((params, qstate, velocity)),
                    jax.tree.leaves(convert.to_jax_numpy(back, vel))):
        np.testing.assert_array_equal(a, b)


def _jax_walk(layer):
    yield layer
    for c in layer.children():
        yield from _jax_walk(c)


def test_registry_and_cli_take_every_model():
    """The port's registry is lbt_tpu's; the CLI takes each of its
    models, and ``--gradient_buffer`` for the CIFAR ResNets only."""
    assert set(MODEL_REGISTRY) == set(jmodels.MODEL_REGISTRY)
    for name in MODEL_REGISTRY:
        assert build_parser().parse_args(["--model", name]).model == name
    args = build_parser().parse_args(["--model", "CIFAR10_Resnet20",
                                      "--gradient_buffer"])
    assert args.gradient_buffer
    with pytest.raises(ValueError, match="unknown model"):
        build_model("no_such_model", tconfig.QuantConfig.uniform(8))
    # main.py ties the bias and BN width to --bits_w
    assert quant_config(build_parser().parse_args(
        ["--bits_w", "4"])).bits_b == 4


@pytest.mark.parametrize("argv", [
    ["--model", "MNIST"],
    ["--model", "CIFAR10_Resnet20", "--gradient_buffer", "--noise_mode",
     "hash"],
    ["--model", "PI_MNIST", "--bits", "32"]],
    ids=["mnist-defaults", "resnet20-gradient-buffer", "pi-mnist-fp32"])
def test_cli_trains_the_new_paths(tmp_path, argv):
    """``python -m lbt_tpu_torch.main`` on the CPU, 2 steps: LeNet under
    main.py's defaults (prng, dropout), ResNet-20 with the gradient
    buffers (sized for the batch, nonzero after the run), the FP32 MLP (a
    model with parameters and no buffer); the loss is finite.
    ``--gradient_buffer`` on another model exits 2."""
    tr = main(argv + ["--device", "cpu", "--n_train", "32", "--n_test",
                      "16", "--batch_size", "16", "--n_epoch", "1",
                      "--log_every", "1", "--exp_path",
                      str(tmp_path / "exp")])
    assert tr.step == 2 and np.isfinite(tr.evaluate()["loss"])
    bufs = [la.buffer for la in tr.model.net.modules()
            if isinstance(la, tlayers.GradientBuffer)]
    assert len(bufs) == (2 if "--gradient_buffer" in argv else 0)
    assert all(b.abs().sum() > 0 for b in bufs)
    if bufs:
        assert bufs[0].shape == (16, 32, 32, 16)
        with pytest.raises(SystemExit) as e:
            main(["--model", "MNIST", "--gradient_buffer", "--device",
                  "cpu", "--exp_path", str(tmp_path / "no")])
        assert e.value.code == 2


@pytest.mark.parametrize("name", ["PI_MNIST", "MNIST", "CIFAR10",
                                  "CIFAR10_VGG"])
def test_small_model_serving_matches_lbt_tpu(name):
    """The serving forward (running statistics, round to nearest, dropout
    off) at batch 2 under uniform(8), random weights and biases: logits at
    rtol = atol = 1e-5, labels equal."""
    cfg = jconfig.QuantConfig.uniform(8)
    jm, model = _build_both(name, cfg)
    model.init(torch.Generator().manual_seed(2))
    with torch.no_grad():
        for k, p in model.net.named_parameters():
            if k.endswith(".b"):
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(3))
    params, qstate, _ = convert.to_jax_numpy(model)
    x = np.random.default_rng(5).normal(
        0, 1, (2, *model.input_shape)).astype(np.float32)

    def fwd(p, q, x):
        return jm.apply(p, q, jm.make_sinks(), x,
                        JCtx(train=False, key=None, update=False))[0]

    want = np.asarray(jax.jit(fwd)(params, qstate, jnp.asarray(x)))
    got = model.apply(torch.from_numpy(x), Ctx(train=False)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def test_lenet_prng_dropout_train_steps_match_lbt_tpu():
    """Three steps of LeNet / MNIST under uniform(8): main.py's defaults,
    the int8 engine with ``prng`` noise and dropout at keep 0.5 (masks
    from the site-4 keys), 5x5 SAME and VALID biased convs through im2col
    and K2's plain version."""
    cfg = jconfig.QuantConfig.uniform(8)
    wd = jconfig.TrainConfig().weight_decay
    jm = jmodels.build_model("MNIST", cfg, weight_decay=wd)
    model = build_model("MNIST", cfg, weight_decay=wd).init(
        torch.Generator().manual_seed(0))
    compare_train_steps(jm, model, (4, 28, 28, 1), 10)


def _vgg_sub(pkg, cfg, wd):
    """VGG-16's pattern at narrow widths: conv3x3 -> BN -> ReLU twice, a
    2x2 max pool, Flatten, Dropout and the dense head."""
    L, Bn, M = ((jlayers, JBatchNorm, JModel) if pkg == "jax"
                else (tlayers, BatchNorm, Model))
    layers = []
    cin = 3
    for r, c in enumerate((8, 16), start=1):
        layers += [L.Conv2d(f"conv1-{r}", cfg, (3, 3, cin, c), (1, 1),
                            "SAME", use_bias=False, weight_decay=wd),
                   Bn(f"conv1-{r}-bn", cfg, c, weight_decay=wd),
                   L.ReLU()]
        cin = c
    layers += [L.MaxPool(ksize=(2, 2), strides=(2, 2), padding="VALID"),
               L.Flatten(), L.Dropout(keep=0.5),
               L.Dense("softmax", cfg, 16 * 4 * 4, 100, weight_decay=wd)]
    return M("vgg_sub", layers, (8, 8, 3), 100, cfg)


def test_vgg_subnet_int4w_train_steps_match_lbt_tpu():
    """Three steps of a VGG-16-shaped sub-net under ``int4w-int8a``: 4-bit
    weight codes (clip [-8, 7]) into the fused conv -> BN route (#4's
    plain version), 9-bit conv activations, dropout, the 100-way head."""
    wd = jconfig.TrainConfig().weight_decay
    model = _vgg_sub("torch", INT4W, wd).init(
        torch.Generator().manual_seed(0))
    compare_train_steps(_vgg_sub("jax", INT4W, wd), model, (4, 8, 8, 3), 100)


def test_resnet8_gradient_buffer_train_steps_match_lbt_tpu():
    """Three steps of ResNet-8 with ``gradient_buffer_batch=4`` (buffers
    after the stem conv, which then runs unfused, and after the head)
    under uniform(8, hash): every tensor as in the other step tests, and
    the error-feedback buffers at rtol = atol = 1e-6, nonzero after a
    step."""
    cfg = jconfig.QuantConfig.uniform(8, noise_mode="hash")
    wd = jconfig.TrainConfig().weight_decay
    jm = jmodels.cifar10_resnet(cfg, 8, weight_decay=wd,
                                gradient_buffer_batch=4)
    model = cifar10_resnet(cfg, 8, weight_decay=wd,
                           gradient_buffer_batch=4).init(
                               torch.Generator().manual_seed(0))

    def buffers(q, jq):
        for name in ("grad-buffer-stem", "grad-buffer-head"):
            got = q[name]["state"]["buffer"]
            want = jq[name]["state"]["buffer"]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
            assert np.abs(got).sum() > 0, name

    compare_train_steps(jm, model, (4, 32, 32, 3), 10, check_state=buffers)
