"""The port's float routes held against lbt_tpu on the CPU: the ``sim`` and
``sim_bf16`` engines, the float fallback for widths the integer engine
cannot hold, the float backward of the integer route, ``SpaceToDepth`` and
the s2d ImageNet stem, serving under ``sim_bf16``, and three train steps
of a CIFAR ResNet-8 under ``bench.py``'s baseline config
(``uniform(8, engine="sim_bf16", noise_mode="prng")``).

``lbt_tpu`` is jitted here without excess precision: allowed it, XLA on
the CPU computes a bf16 contraction in f32 and drops the rounding of its
output to bf16 (ROADMAP queue 3), which the port, the TPU and the card
keep.  Each test states what it holds bitwise and what at a
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbt_tpu.config as jconfig
from lbt_tpu.models import imagenet_resnet as jimagenet_resnet
from lbt_tpu.nn.core import Ctx as JCtx
from lbt_tpu.nn.core import make_sinks
from lbt_tpu.nn.layers import SpaceToDepth as JSpaceToDepth
from lbt_tpu.ops import qops as jops
from lbt_tpu_torch import convert
from lbt_tpu_torch.infer import Predictor, make_predict_fn
from lbt_tpu_torch.models import cifar10_resnet, imagenet_resnet
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.nn.layers import SpaceToDepth
from lbt_tpu_torch.ops import qops
from test_torch_resnet import _randomize
from test_torch_train import (NO_EXCESS_PRECISION, compare_train_steps,
                              resnet_pair)

pytest_plugins = ["torch_suite"]

_EVAL = JCtx(train=False, key=None, update=False)


_KX, _KW = (3, 0x9E3779B9), (0xDEADBEEF, 12)

# (engine, bits_x, bits_w, bits_g, forward and gradients bitwise?):
# sim / sim_bf16 at 8 bits sum exactly in f32 (codes of at most 9 bits
# times 8, K <= 144) and take a cotangent on an 8-bit grid exactly;
# 16-bit codes make products past f32's 24 bits (the int8 engine's float
# fallback), and the integer route's float backward (bits_g = 16) sums a
# 16-bit cotangent in f32, so those hold at rtol 1e-5
CASES = {
    "sim": ("sim", 8, 8, 8, True),
    "sim_bf16": ("sim_bf16", 8, 8, 8, True),
    "fallback_w16a16g16": ("int8", 16, 16, 16, False),
    "int_route_g16": ("int8", 8, 8, 16, False),
}


def _grid(rng, shape, bits, exp):
    lim = 2 ** (bits - 1)
    return (rng.integers(-lim, lim, shape) / 2.0 ** (bits - 1 - exp)
            ).astype(np.float32)


def _check(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _both(jfn, tfn, x, w, g_bits, exact):
    """Outputs and both gradients of ``jfn`` (lbt_tpu) and ``tfn`` (the
    port) for a cotangent on a ``g_bits``-wide grid."""
    x, w = jnp.asarray(x), jnp.asarray(w)
    rng = np.random.default_rng(x.size)
    g = _grid(rng, jax.eval_shape(jfn, x, w).shape, g_bits, -2)

    def fwd_bwd(x, w, g):
        y, vjp = jax.vjp(jfn, x, w)
        return (y, *vjp(g))

    y, want_dx, want_dw = jax.jit(fwd_bwd, compiler_options=(
        NO_EXCESS_PRECISION))(x, w, jnp.asarray(g))
    x, w = np.asarray(x), np.asarray(w)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = tfn(tx, tw)
    _check(ty.detach().numpy(), np.asarray(y), exact)
    ty.backward(torch.from_numpy(g))
    _check(tx.grad.numpy(), np.asarray(want_dx), exact)
    _check(tw.grad.numpy(), np.asarray(want_dw), exact)


@pytest.mark.parametrize("case,stochastic", [
    ("sim", True), ("sim_bf16", False), ("fallback_w16a16g16", True),
    ("int_route_g16", True)])
def test_qmatmul_float_routes_match_lbt_tpu(case, stochastic):
    """``qmatmul`` on each float route: output, dx and dW against
    ``lbt_tpu``'s (bitwise or rtol 1e-5 as ``CASES`` says).  With
    stochastic rounding the sim routes draw threefry noise although the
    configured backend is a hash, as ``lbt_tpu``'s do."""
    engine, bx, bw, bg, exact = CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.normal(0, 1, (6, 64)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (64, 10)).astype(np.float32)
    kw = dict(bits_x=bx, bits_w=bw, bits_g=bg, engine=engine,
              stochastic=stochastic, backend="xla_hash")
    keys = [jax.random.wrap_key_data(np.asarray(k, np.uint32))
            for k in (_KX, _KW)] if stochastic else [None, None]

    def jfn(x, w):
        return jops.qmatmul(x, w, jnp.int32(1), jnp.int32(0),
                            jnp.int32(-2), key_x=keys[0], key_w=keys[1],
                            **kw)

    def tfn(x, w):
        return qops.qmatmul(x, w, 1, 0, exp_g=-2, key_x=_KX, key_w=_KW,
                            **kw)

    _both(jfn, tfn, x, w, bg, exact)


@pytest.mark.parametrize("case,stride", [
    ("sim", 2), ("sim_bf16", 1), ("fallback_w16a16g16", 2),
    ("int_route_g16", 1)])
def test_qconv2d_float_routes_match_lbt_tpu(case, stride):
    """``qconv2d`` (NHWC x HWIO, SAME) on each float route, stochastic:
    output, dx and dW against ``lbt_tpu``'s, as ``CASES`` says; conv
    activations one bit wider, as the layers quantize them."""
    engine, bx, bw, bg, exact = CASES[case]
    rng = np.random.default_rng(len(case) + stride)
    x = rng.normal(0, 1, (2, 7, 8, 16)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (3, 3, 16, 8)).astype(np.float32)
    kw = dict(strides=(stride, stride), padding="SAME", bits_x=bx + 1,
              bits_w=bw, bits_g=bg, engine=engine, stochastic=True,
              backend="xla_hash1")
    keys = [jax.random.wrap_key_data(np.asarray(k, np.uint32))
            for k in (_KX, _KW)]

    def jfn(x, w):
        return jops.qconv2d(x, w, jnp.int32(1), jnp.int32(0),
                            jnp.int32(-2), key_x=keys[0], key_w=keys[1],
                            **kw)

    def tfn(x, w):
        return qops.qconv2d(x, w, 1, 0, exp_g=-2, key_x=_KX, key_w=_KW,
                            **kw)

    _both(jfn, tfn, x, w, bg, exact)


def test_space_to_depth_matches_lbt_tpu():
    """Forward bitwise (a permutation) and the gradient through it."""
    x = np.random.default_rng(0).normal(0, 1, (2, 6, 8, 3)).astype(
        np.float32)
    want = np.asarray(JSpaceToDepth(block=2).apply({}, {}, {},
                                                   jnp.asarray(x), None)[0])
    tx = torch.from_numpy(x).requires_grad_()
    got = SpaceToDepth(block=2)(tx, Ctx(train=False))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.backward(got.detach())
    np.testing.assert_array_equal(tx.grad.numpy(), x)
    with pytest.raises(ValueError):
        SpaceToDepth(block=2)(torch.zeros(1, 5, 4, 3), Ctx(train=False))


def test_s2d_stem_imagenet_resnet_matches_lbt_tpu():
    """An ImageNet ResNet-18 with the s2d stem: the port's trees have
    ``lbt_tpu``'s structure and shapes (its 4x4x12x64 stem among them) and
    cross the converter both ways unchanged; the stem (``SpaceToDepth``,
    the 4x4/s1 conv, BN, ReLU, max pool), run by each model's own layers
    on randomized weights, serves the same forward at rtol = atol =
    1e-5."""
    cfg = jconfig.QuantConfig.uniform(8, stem_s2d=True)
    jm = jimagenet_resnet(cfg, 18, num_classes=10, image_size=32)
    model = imagenet_resnet(cfg, 18, num_classes=10, image_size=32).init(
        torch.Generator().manual_seed(1))
    params, qstate, _ = convert.to_jax_numpy(model)
    shapes = jax.eval_shape(jm.init, jax.random.key(1))
    assert jax.tree.structure(shapes) == jax.tree.structure((params, qstate))
    for want, got in zip(jax.tree.leaves(shapes),
                         jax.tree.leaves((params, qstate))):
        assert (want.shape, want.dtype) == (got.shape, got.dtype)
    assert params["conv1"]["W"].shape == (4, 4, 12, 64)
    params, qstate = _randomize(params, qstate, seed=2)
    convert.from_jax_numpy(model, params, qstate)
    for a, b in zip(jax.tree.leaves((params, qstate)),
                    jax.tree.leaves(convert.to_jax_numpy(model)[:2])):
        np.testing.assert_array_equal(a, b)

    n = 5  # SpaceToDepth, conv1, conv1-bn, ReLU, MaxPool
    jstem = jm.net.layers[:n]
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 32, 3)).astype(
        np.float32)

    def jforward(p, q, x):
        for layer in jstem:
            x = layer.apply(p.get(layer.name, {}), q.get(layer.name, {}),
                            make_sinks(layer), x, _EVAL)[0]
        return x

    want = np.asarray(jax.jit(jforward)(params, qstate, jnp.asarray(x)))
    got = torch.from_numpy(x)
    for layer in model.net.layers[:n]:
        got = layer(got, Ctx(train=False))
    assert [type(m).__name__ for m in model.net.layers[:n]] == [
        type(m).__name__ for m in jstem]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("engine", ["sim", "sim_bf16"])
def test_predictor_serves_sim_engines(engine):
    """``Predictor`` on a ResNet-8 under each sim engine: its labels and
    probabilities are those of the model's serving forward, which
    ``tests/test_torch_resnet.py`` holds against ``lbt_tpu``'s
    (``test_unported_config_options_raise``)."""
    cfg = jconfig.QuantConfig.uniform(8, engine=engine, noise_mode="prng")
    x = np.random.default_rng(6).normal(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    model = cifar10_resnet(cfg, 8).init(torch.Generator().manual_seed(5))
    predictor = Predictor(model, device="cpu")
    logits = model.apply(torch.from_numpy(x), Ctx(train=False))
    assert torch.isfinite(logits).all()
    np.testing.assert_array_equal(predictor(x).numpy(),
                                  logits.argmax(-1).numpy())
    labels, probs = make_predict_fn(model, return_probs=True)(
        torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(),
                               torch.softmax(logits, -1).numpy(), rtol=1e-6)


def test_entry_points_turn_tf32_off_for_their_calls():
    """The train step, the eval step and the predict function run their
    forward with TF32 off (their f32 contractions full f32 on the card)
    and give the process its own setting back after, also when the call
    raises: no op of the port changes it for the rest of the process."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.dfxp.keys import base_key
    from lbt_tpu_torch.train.optim import momentum_init
    from lbt_tpu_torch.train.step import make_eval_step, make_train_step
    from lbt_tpu_torch.utils.device import full_f32
    cfg = jconfig.QuantConfig.uniform(8, engine="sim", noise_mode="prng")
    model = cifar10_resnet(cfg, 8).init(torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (2, 32, 32, 3)).astype(np.float32))
    y = torch.tensor([1, 7])
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    seen, forward = [], model.apply

    def spy(x, ctx):
        seen.append(tuple(f.allow_tf32 for f in flags))
        return forward(x, ctx)

    model.apply = spy
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        vel = momentum_init(dict(model.net.named_parameters()))
        make_train_step(model, TrainConfig())(model, vel, x, y, 0, 1e-2,
                                              base_key(1))
        make_eval_step(model)(model, x, y, base_key(2))
        make_predict_fn(model)(x)
        assert seen == [(False, False)] * 3
        assert [f.allow_tf32 for f in flags] == [True, True]
        with pytest.raises(RuntimeError, match="inside"):
            with full_f32():
                raise RuntimeError("inside")
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_resnet8_sim_bf16_prng_train_steps_match_lbt_tpu():
    """Three steps of ResNet-8 under ``bench.py``'s baseline config
    (sim_bf16, prng noise, unfused BN, f32 carriers, controllers every
    step), against lbt_tpu's step, at the tolerances of
    :func:`compare_train_steps`."""
    compare_train_steps(*resnet_pair(jconfig.QuantConfig.uniform(
        8, engine="sim_bf16", noise_mode="prng")))
