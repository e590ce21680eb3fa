"""The port's serving forward held against lbt_tpu: full-width
CIFAR10_Resnet20 and its layer classes, eval mode on running statistics.

Weights come from lbt_tpu's init and are loaded with the converter.
Before that, BN running statistics, gamma and beta are randomized and
every exponent is drawn from [-2, 2] (numpy, seeded), so each path does
real work.  Tolerance: rtol = atol = 1e-5.  Every quantize, contraction
and BN operation is the same operation in the same order in both
frameworks, and the 9-bit convs are exact in both; what is left is the
order of AvgPool's 8x8 window sum, measured at <= 1 ulp between XLA-CPU
and torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbt_tpu.config import QuantConfig
from lbt_tpu.models import cifar10_resnet as jax_resnet
from lbt_tpu.nn import Sequential as JSequential
from lbt_tpu.nn.blocks import ResidualBlock as JResidualBlock
from lbt_tpu.nn.core import Ctx as JCtx
from lbt_tpu.nn.core import finalize as jfinalize
from lbt_tpu.nn.core import make_sinks
from lbt_tpu.nn.layers import Conv2d as JConv2d
from lbt_tpu.nn.norm import BatchNorm as JBatchNorm
from lbt_tpu_torch.convert import from_jax_numpy, load_jax_numpy
from lbt_tpu_torch.infer import Predictor, make_predict_fn
from lbt_tpu_torch.models import build_model, cifar10_resnet
from lbt_tpu_torch.nn.blocks import ResidualBlock
from lbt_tpu_torch.nn.core import Ctx, Sequential, finalize
from lbt_tpu_torch.nn.layers import Conv2d
from lbt_tpu_torch.nn.norm import BatchNorm

pytest_plugins = ["torch_suite"]

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {
    "uniform8": QuantConfig.uniform(8),
    "uniform8_a8conv": QuantConfig.uniform(8, conv_act_extra=0),
}
_EVAL = JCtx(train=False, key=None, update=False)


def _randomize(params, qstate, seed):
    """numpy copies of the trees with BN stats, gamma, beta and every
    exponent redrawn."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype == np.int32:  # exponent
            return np.asarray(rng.integers(-2, 3), np.int32)
        if key == "mean":
            return rng.normal(0, 0.5, a.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if key == "gamma":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if key == "beta":
            return rng.normal(0, 0.3, a.shape).astype(np.float32)
        return a

    return walk(params), walk(qstate)


def _jax_layer_forward(layer, params, qstate, x, compiler_options=None,
                       key=None):
    """``layer``'s eval forward, rounding stochastically under ``key``."""
    sinks = make_sinks(layer)
    ctx = _EVAL if key is None else JCtx(train=False, key=key, update=False)
    fn = jax.jit(lambda p, q, s, x: layer.apply(p, q, s, x, ctx)[0],
                 compiler_options=compiler_options)
    return np.asarray(fn(params, qstate, sinks, jnp.asarray(x)))


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_resnet20_serving_matches_lbt_tpu(cfg_name):
    cfg = CONFIGS[cfg_name]
    jmodel = jax_resnet(cfg, 20)
    params, qstate = _randomize(*jmodel.init(jax.random.key(3)), seed=11)
    x = np.random.default_rng(4).normal(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    want = _jax_layer_forward(jmodel.net, params, qstate, x)

    model = cifar10_resnet(cfg, 20)
    from_jax_numpy(model, params, qstate)
    got = model.apply(torch.from_numpy(x), Ctx(train=False)).detach()
    assert got.shape == (4, 10) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    labels = Predictor(model, device="cpu")(x)
    np.testing.assert_array_equal(labels.numpy(), want.argmax(-1))
    labels2, probs = make_predict_fn(model, return_probs=True)(
        torch.from_numpy(x))
    np.testing.assert_array_equal(labels2.numpy(), labels.numpy())
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("bits_x_extra", [1, 0])
def test_conv_bn_layer_matches_lbt_tpu(bits_x_extra):
    cfg = QuantConfig.uniform(8, conv_act_extra=bits_x_extra)
    jlayer = jfinalize(JSequential("stem", [
        JConv2d("conv1", cfg, (3, 3, 3, 16), (1, 1), "SAME",
                use_bias=False),
        JBatchNorm("conv1-bn", cfg, 16)]))
    params, qstate = _randomize(*jlayer.init(jax.random.key(0)), seed=1)
    x = np.random.default_rng(2).normal(0, 1, (3, 9, 9, 3)).astype(
        np.float32)
    want = _jax_layer_forward(jlayer, params, qstate, x)

    layer = finalize(Sequential("stem", [
        Conv2d("conv1", cfg, (3, 3, 3, 16), (1, 1), "SAME", use_bias=False),
        BatchNorm("conv1-bn", cfg, 16)]))
    load_jax_numpy(layer, params, qstate)
    got = layer(torch.from_numpy(x), Ctx(train=False))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("stride,cin", [(2, 16), (1, 16)])
def test_residual_block_matches_lbt_tpu(stride, cin):
    cfg = QuantConfig.uniform(8)
    cout = 32 if stride == 2 else 16
    jblock = jfinalize(JResidualBlock("block", cfg, cin, cout, stride))
    params, qstate = _randomize(*jblock.init(jax.random.key(5)), seed=6)
    x = np.random.default_rng(7).normal(0, 1, (2, 8, 8, cin)).astype(
        np.float32)
    want = _jax_layer_forward(jblock, params, qstate, x)

    block = finalize(ResidualBlock("block", cfg, cin, cout, stride))
    assert [m.uid for m in (block.residual, block.shortcut)] == [
        jblock.residual.uid, jblock.shortcut.uid]
    load_jax_numpy(block, params, qstate)
    got = block(torch.from_numpy(x), Ctx(train=False))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_converter_raises_on_mismatch():
    cfg = QuantConfig.uniform(8)
    params, qstate = jax_resnet(cfg, 20).init(jax.random.key(0))
    params, qstate = _randomize(params, qstate, seed=0)
    model = cifar10_resnet(cfg, 20)
    bad = dict(params)
    bad["softmax"] = {"W": np.zeros((64, 11), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        from_jax_numpy(model, bad, qstate)
    bad = dict(params)
    del bad["conv1"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_numpy(model, bad, qstate)
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_numpy(cifar10_resnet(cfg, 32), params, qstate)


@pytest.mark.parametrize("kw", [
    dict(engine="sim"), dict(engine="sim_bf16"), dict(remat_bn=True),
    dict(bn_residual_q16=True), dict(noise_shared_axis0=True),
    dict(stem_s2d=True), dict(noise_impl="unsafe_rbg")])
def test_unported_config_options_raise(kw):
    """The options ported since build, each refused before: the noise
    shared along axis 0 and the s2d stem (a no-op on a CIFAR stem, as in
    ``lbt_tpu``) build the same layers as the default; both sim engines,
    the ``unsafe_rbg`` key and the BN memory options ``remat_bn`` and
    ``bn_residual_q16`` (training only: serving is untouched), a conv ->
    BN -> ReLU -> pool -> dense stack whose serving forward equals
    ``lbt_tpu``'s, at rtol = atol = 1e-5 (every contraction's sum is
    exact, and under ``sim_bf16`` rounds once to bf16 in both); under the
    ``unsafe_rbg`` key the forward is given one, so every site rounds
    stochastically with the Philox stream (its codes bitwise, as
    ``tests/test_torch_rbg.py`` holds them).  ``lbt_tpu`` is jitted
    without excess precision: allowed it, XLA on the CPU computes a bf16
    contraction in f32 and drops the rounding of its output to bf16,
    which the port, the TPU and the card keep (ROADMAP queue 3)."""
    cfg = QuantConfig.uniform(8, **kw)
    if set(kw) <= {"noise_shared_axis0", "stem_s2d"}:
        names = [n for n, _ in cifar10_resnet(cfg, 20).net.named_modules()]
        assert names == [n for n, _ in cifar10_resnet(
            QuantConfig.uniform(8), 20).net.named_modules()]
        return
    from lbt_tpu.nn.layers import AvgPool as JAvgPool
    from lbt_tpu.nn.layers import Dense as JDense
    from lbt_tpu.nn.layers import Flatten as JFlatten
    from lbt_tpu.nn.layers import ReLU as JReLU
    from lbt_tpu_torch.nn.layers import AvgPool, Dense, Flatten, ReLU
    jnet = jfinalize(JSequential("net", [
        JConv2d("conv", cfg, (3, 3, 3, 16), (2, 2), "SAME", use_bias=False),
        JBatchNorm("bn", cfg, 16), JReLU(),
        JAvgPool(ksize=(4, 4), strides=(1, 1)), JFlatten(),
        JDense("head", cfg, 16, 10)]))
    params, qstate = _randomize(*jnet.init(jax.random.key(3)), seed=12)
    x = np.random.default_rng(5).normal(0, 1, (2, 8, 8, 3)).astype(
        np.float32)
    key = (jax.random.key(7, impl=kw["noise_impl"]) if "noise_impl" in kw
           else None)
    want = _jax_layer_forward(jnet, params, qstate, x,
                              {"xla_allow_excess_precision": False}, key)

    def serve(c):
        net = finalize(Sequential("net", [
            Conv2d("conv", c, (3, 3, 3, 16), (2, 2), "SAME",
                   use_bias=False),
            BatchNorm("bn", c, 16), ReLU(),
            AvgPool(ksize=(4, 4), strides=(1, 1)), Flatten(),
            Dense("head", c, 16, 10)]))
        load_jax_numpy(net, params, qstate)
        return net(torch.from_numpy(x), Ctx(
            train=False, key=None if key is None else
            np.asarray(jax.random.key_data(key)))).detach().numpy()

    got = serve(cfg)
    np.testing.assert_allclose(got, want, **TOL)
    if set(kw) & {"remat_bn", "bn_residual_q16"}:
        # serving is untouched: the logits without the option, bitwise
        np.testing.assert_array_equal(got, serve(QuantConfig.uniform(8)))


def test_imagenet_resnet_refuses_the_s2d_stem():
    """The space-to-depth stem of the ImageNet ResNets, refused before it
    was ported: ``SpaceToDepth`` then the 4x4/s1 conv over 12 channels,
    with ``lbt_tpu``'s layer names (the converter's trees carry its
    4x4x12x64 stem both ways).  Its embedding of the 7x7/s2 stem and its
    forward are held in ``tests/test_torch_sim.py``."""
    from lbt_tpu_torch.models import imagenet_resnet
    from lbt_tpu_torch.nn.layers import SpaceToDepth
    cfg = QuantConfig.uniform(8, fused_bn=True, act_dtype="bf16",
                              stem_s2d=True)
    model = imagenet_resnet(cfg, 50)
    stem = model.net.layers[:2]
    assert isinstance(stem[0], SpaceToDepth) and stem[0].block == 2
    assert stem[1].name == "conv1" and stem[1].ksize == (4, 4, 12, 64)
    assert stem[1].strides == (1, 1)
    assert stem[1].padding == ((1, 2), (1, 2))
    plain = imagenet_resnet(QuantConfig.uniform(8, fused_bn=True,
                                                act_dtype="bf16"), 50)
    assert plain.net.layers[0].ksize == (7, 7, 3, 64)
    assert model.num_layers() == plain.num_layers() + 1


def test_registry_and_serving_only_context():
    cfg = QuantConfig.uniform(8, engine="pallas")
    model = build_model("CIFAR10_Resnet32", cfg)
    assert model.name == "cifar10_resnet32"
    # lbt_tpu's other registry models (refused before they were ported)
    assert build_model("MNIST", cfg).name == "lenet_mnist"
    assert build_model("VGG16_CIFAR100", cfg).name == "vgg16"
    with pytest.raises(ValueError):
        build_model("no_such_model", cfg)
    # training with threefry 'prng' noise (refused before it was ported)
    small = cifar10_resnet(cfg, 8).init(torch.Generator().manual_seed(0))
    out = small.apply(torch.zeros(1, 32, 32, 3),
                      Ctx(train=True, key=np.array([0, 1], np.uint32)))
    assert out.shape == (1, 10) and torch.isfinite(out).all()


def test_init_is_seeded_and_device_independent():
    cfg = QuantConfig.uniform(8)
    a = cifar10_resnet(cfg, 20).init(torch.Generator().manual_seed(9))
    b = cifar10_resnet(cfg, 20).init(torch.Generator().manual_seed(9))
    for (na, pa), (nb, pb) in zip(a.net.named_parameters(),
                                  b.net.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    w = a.net.layers[0].W
    limit = (3.0 / 27) ** 0.5
    assert w.abs().max() <= limit and w.std() > limit / 3
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    loss, acc = a.loss_and_acc(a.apply(x, Ctx(train=False)),
                               torch.tensor([0, 1]))
    assert torch.isfinite(loss) and 0.0 <= acc.item() <= 1.0
