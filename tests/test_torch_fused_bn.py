"""The headline configuration's layers held against lbt_tpu on the CPU:
``FusedBatchNorm`` alone and behind a conv through the fused route (the
plain version of kernels #4 / #5), ``MaxPool`` and ``ResidualBottleneck``,
under f32 and bf16 carriers with ``hash1`` noise; and three ResNet-50
train steps under f32 carriers (the bf16 run is in
``test_torch_imagenet.py``, so the two lbt_tpu compiles run on two
workers).

Integer results (BN input codes, exponents, the stat sinks) are compared
bitwise.  Float outputs, gradients and BN state at rtol 1e-5: lbt_tpu
takes its batch moments as f32 means and its variance as ``m2 - mean^2``
in f32, the port from exact code sums rounded once (ROADMAP queue 3,
case 2).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbt_tpu.nn import Sequential as JSequential
from lbt_tpu.nn.blocks import ResidualBottleneck as JBottleneck
from lbt_tpu.nn.core import Ctx as JCtx
from lbt_tpu.nn.core import finalize as jfinalize
from lbt_tpu.nn.core import make_sinks as jmake_sinks
from lbt_tpu.nn.layers import Conv2d as JConv2d
from lbt_tpu.nn.layers import MaxPool as JMaxPool
from lbt_tpu.nn.norm import BatchNorm as JBatchNorm
from lbt_tpu.ops import qops as jops
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch.convert import dump_jax_numpy, load_jax_numpy
from lbt_tpu_torch.nn import norm as norm_module
from lbt_tpu_torch.nn.blocks import ResidualBottleneck
from lbt_tpu_torch.nn.core import Ctx, Sequential, finalize, make_sinks
from lbt_tpu_torch.nn.layers import Conv2d, MaxPool
from lbt_tpu_torch.nn.norm import BatchNorm, FusedBatchNorm
from lbt_tpu_torch.ops import qops

from test_torch_imagenet import headline, resnet50_steps_match_lbt_tpu

jq = importlib.import_module("lbt_tpu.dfxp.quantize")

TOL = dict(rtol=1e-5, atol=1e-6)
CARRIERS = {"f32": (jnp.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16)}
# train = a training forward and backward; eval = serving (running
# moments, no key); update = the running moments' EMA and the controllers
# without training behaviour
MODES = {"train": (True, True), "eval": (False, False),
         "update": (False, True)}


def _kd(key):
    return np.asarray(jax.random.key_data(key))


def _randomize(params, qstate, seed, exp_g=-3):
    """BN statistics, gamma and beta redrawn; every exponent 2, the
    gradient sites' ``exp_g``."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype == np.int32:
            return np.asarray(exp_g if key == "grad" else 2, np.int32)
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


def _to_np(t):
    return t.detach().to(torch.float32).numpy()


def run_both(jlayer, layer, x, mode, carrier, g=None, seed=3, jit=True):
    """One call of the JAX layer (jitted, or eagerly with ``jit=False``)
    and of the port's on the same trees, input, key and cotangent ``g``
    (train mode).  Returns ``(jax, port)`` dicts of ``y``, ``dx``,
    parameter gradients, sink gradients and the new (params, qstate)
    trees, as numpy, and lbt_tpu's params."""
    train, update = MODES[mode]
    j_dt = CARRIERS[carrier][0]
    key = jax.random.key(seed) if train or update else None
    params, qstate = _randomize(*jlayer.init(jax.random.key(0)), seed=seed)

    jctx = JCtx(train=train, key=key, update=update)
    sinks = jmake_sinks(jlayer)
    xj = jnp.asarray(x).astype(j_dt)
    compiled = jax.jit if jit else (lambda f: f)

    def fwd(x, p, s):
        return jlayer.apply(p, qstate, s, x, jctx)

    if train:
        @compiled
        def run(x, p, s, g):
            y, vjp, q = jax.vjp(fwd, x, p, s, has_aux=True)
            return y, q, vjp(g.astype(y.dtype))
        y, q, (dx, dp, ds) = run(xj, params, sinks, jnp.asarray(g))
        want = {"y": y, "q": q, "dx": dx, "dp": dp, "ds": ds}
    else:
        y, q = compiled(fwd)(xj, params, sinks)
        want = {"y": y, "q": q}
    want = jax.tree.map(lambda a: np.asarray(a).astype(
        np.int32 if a.dtype == jnp.int32 else np.float32), want)
    got = run_port(layer, params, qstate, x, mode, carrier, g, seed)
    return want, got, params


def run_port(layer, params, qstate, x, mode, carrier, g=None, seed=3):
    """The port's half of :func:`run_both`: ``layer`` loaded with
    lbt_tpu's trees, called on ``x`` (in the carrier) with the key of
    ``seed``."""
    train, update = MODES[mode]
    j_dt, t_dt = CARRIERS[carrier]
    key = jax.random.key(seed) if train or update else None
    xj = jnp.asarray(x).astype(j_dt)
    load_jax_numpy(layer, params, qstate)
    tsinks = make_sinks(layer)
    ctx = Ctx(train=train, key=None if key is None else _kd(key),
              update=update, sinks=dict(tsinks))
    tx = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(t_dt)
    if train:
        tx.requires_grad_()
        ty = layer(tx, ctx)
        ty.backward(torch.from_numpy(g).to(ty.dtype))
    else:
        with torch.no_grad():
            ty = layer(tx, ctx)
    ctx.commit()
    p, qs, _ = dump_jax_numpy(layer)
    got = {"y": _to_np(ty), "q": qs, "p": p}
    if train:
        got["dx"] = _to_np(tx.grad)
        got["dp"] = {k: _to_np(v.grad) for k, v in layer.named_parameters()}
        got["ds"] = {uid: _to_np(s.grad) for uid, s in tsinks.items()}
    return got


def _compare_state(got, want, path=""):
    """Exponents bitwise, BN statistics at TOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _compare_state(got[k], want[k], f"{path}/{k}")
    elif want.dtype == np.int32:
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)


def _flat_grads(tree, prefix=""):
    """lbt_tpu's params-layout gradient tree as ``{'a.layers.0.W': ...}``
    keys of the port's ``named_parameters`` (child names)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_grads(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _param_paths(layer):
    """``named_parameters`` name -> lbt_tpu tree path of each parameter."""
    from lbt_tpu_torch.nn.core import layer_paths
    owner = {}
    for path, sub in layer_paths(layer):
        for k, p in sub.named_parameters(recurse=False):
            owner[id(p)] = f"{path}/{k}"
    return {n: owner[id(p)] for n, p in layer.named_parameters()}


def _sink_paths(layer):
    from lbt_tpu_torch.nn.core import layer_paths
    return {sub.uid: path for path, sub in layer_paths(layer)
            if sub.has_grad_sink()}


def compare_train(want, got, layer):
    """Gradients at TOL; stat sinks bitwise."""
    np.testing.assert_allclose(got["dx"], want["dx"], **TOL)
    wgrads = _flat_grads(want["dp"])
    for name, path in _param_paths(layer).items():
        np.testing.assert_allclose(got["dp"][name], wgrads[path],
                                   err_msg=path, **TOL)
    wsinks = _flat_grads(want["ds"])
    for uid, path in _sink_paths(layer).items():
        np.testing.assert_array_equal(got["ds"][uid], wsinks[f"{path}/grad"],
                                      err_msg=path)


@pytest.fixture
def record_codes(monkeypatch):
    """Every BN input site's codes the port makes (K1 and #4 / #5)."""
    codes = []

    def wrap(fn):
        def rec(*a, **k):
            out = fn(*a, **k)
            codes.append(out[0])
            return out
        return rec

    monkeypatch.setattr(norm_module, "quantize_int",
                        wrap(norm_module.quantize_int))
    monkeypatch.setattr(qops, "conv3x3_fused", wrap(qops.conv3x3_fused))
    monkeypatch.setattr(qops, "conv1x1_fused", wrap(qops.conv1x1_fused))
    return codes


@pytest.mark.parametrize("carrier", sorted(CARRIERS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_batchnorm_matches_lbt_tpu(mode, carrier, record_codes):
    """``BatchNorm`` under ``fused_bn`` (its one child ``FusedBatchNorm``
    named ``fused``): output, new exponents and BN state, and in training
    the input, gamma and beta gradients and the sink; its BN input codes
    bitwise against lbt_tpu's ``quantize_int`` at the site's key."""
    jcfg, tcfg = headline(carrier), headline(carrier, tconfig)
    jlayer = jfinalize(JBatchNorm("bn", jcfg, 24))
    layer = finalize(BatchNorm("bn", tcfg, 24))
    assert isinstance(layer.layers[0], FusedBatchNorm)
    assert layer.layers[0].name == "fused"
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 6, 5, 24)).astype(np.float32)
    g = (rng.normal(0, 1, x.shape) * 2.0 ** -6).astype(np.float32)
    want, got, _ = run_both(jlayer, layer, x, mode, carrier, g)
    np.testing.assert_allclose(got["y"], want["y"], **TOL)
    _compare_state(got["q"], want["q"])
    if mode == "train":
        compare_train(want, got, layer)
    train, update = MODES[mode]
    key = jax.random.key(3) if train or update else None
    jctx = JCtx(train=train, key=key, update=update)
    xf = jnp.asarray(x).astype(CARRIERS[carrier][0]).astype(jnp.float32)
    codes, _ = jq.quantize_int(
        xf, 8, jnp.int32(2), jctx.layer_key(jlayer.layers[0].uid, 0),
        stochastic=key is not None, backend="xla_hash1")
    assert len(record_codes) == 1
    np.testing.assert_array_equal(record_codes[0].numpy(),
                                  np.asarray(codes, np.int8))


CONV_CASES = {"3x3s1": ((2, 8, 8, 16), (3, 3, 16, 32), 1),
              "3x3s2": ((2, 9, 9, 16), (3, 3, 16, 32), 2),
              "1x1s2": ((2, 8, 8, 32), (1, 1, 32, 64), 2)}


def _conv_bn(mod, cfg, wshape, s):
    return [mod[0]("conv", cfg, wshape, (s, s), "SAME", use_bias=False),
            mod[1]("conv-bn", cfg, wshape[3])]


@pytest.mark.parametrize("carrier", sorted(CARRIERS))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_fused_batchnorm_route_matches_lbt_tpu(case, carrier,
                                                    record_codes,
                                                    monkeypatch):
    """conv -> FusedBatchNorm in training through the port's fused route
    (#4 / #5's plain version) against lbt_tpu's conv, carrier cast, then
    FusedBatchNorm: the BN input codes and the conv's sink bitwise (under
    bf16 they hold only if the fused route rounds the conv output and its
    cotangent through the carrier, as lbt_tpu's casts do), then the
    port's unfused route equal to its fused route in every output."""
    xshape, wshape, s = CONV_CASES[case]
    jcfg, tcfg = headline(carrier), headline(carrier, tconfig)
    jnet = jfinalize(JSequential("net", _conv_bn((JConv2d, JBatchNorm),
                                                 jcfg, wshape, s)))
    net = finalize(Sequential("net", _conv_bn((Conv2d, BatchNorm), tcfg,
                                              wshape, s)))
    rng = np.random.default_rng(sum(wshape) + s)
    x = rng.normal(0, 1, xshape).astype(np.float32)
    ho = -(-xshape[1] // s)
    g = (rng.normal(0, 1, (xshape[0], ho, -(-xshape[2] // s), wshape[3]))
         * 2.0 ** -6).astype(np.float32)
    want, got, params = run_both(jnet, net, x, "train", carrier, g)
    np.testing.assert_allclose(got["y"], want["y"], **TOL)
    _compare_state(got["q"], want["q"])
    compare_train(want, got, net)

    # lbt_tpu's BN input codes: its conv's output in the carrier, quantized
    # at the BN site's key
    jctx = JCtx(train=True, key=jax.random.key(3), update=True)
    conv, fused = jnet.layers[0], jnet.layers[1].layers[0]
    j_dt = CARRIERS[carrier][0]
    y = jops.qconv2d(
        jnp.asarray(x).astype(j_dt).astype(jnp.float32),
        jnp.asarray(params["conv"]["W"]), jnp.int32(2), jnp.int32(2),
        jnp.int32(-3), strides=(s, s), padding="SAME", bits_x=8, bits_w=8,
        bits_g=8, engine="int8", stochastic=True, backend="xla_hash1",
        key_x=jctx.layer_key(conv.uid, 0), key_w=jctx.layer_key(conv.uid, 1))
    codes, _ = jq.quantize_int(y.astype(j_dt).astype(jnp.float32), 8,
                               jnp.int32(2), jctx.layer_key(fused.uid, 0),
                               stochastic=True, backend="xla_hash1")
    assert len(record_codes) == 1  # one fused kernel call, no K1 site
    np.testing.assert_array_equal(record_codes[0].numpy(),
                                  np.asarray(codes, np.int8))

    monkeypatch.setattr(BatchNorm, "fuses_with", lambda self, layer: False)
    _, unfused, _ = run_both(jnet, net, x, "train", carrier, g)
    for k in ("y", "dx"):
        np.testing.assert_array_equal(unfused[k], got[k], err_msg=k)
    for part in ("dp", "ds"):
        for k in got[part]:
            np.testing.assert_array_equal(unfused[part][k], got[part][k],
                                          err_msg=f"{part} {k}")
    _compare_state(unfused["q"], got["q"])


def _bf16_ulp(a):
    """One bfloat16 ulp at each element's magnitude (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("carrier", sorted(CARRIERS))
@pytest.mark.parametrize("pool", ["3x3s2_same", "2x2s2_valid",
                                  "3x3s1_same"])
def test_maxpool_matches_lbt_tpu_with_ties(pool, carrier):
    """Forward and backward of ``MaxPool`` on inputs full of exact ties
    (ReLU outputs on a coarse grid), SAME at an odd and an even size (pads
    (0, 1) at 3x3/2): the forward bitwise; the backward sends each
    window's cotangent to its first maximum, and overlapping windows add
    in row-major window order.  Bitwise under f32 carriers; under bf16
    within one bf16 ulp, since XLA's order and width of the bf16 sums are
    not specified."""
    k, s, padding = {"3x3s2_same": (3, 2, "SAME"),
                     "2x2s2_valid": (2, 2, "VALID"),
                     "3x3s1_same": (3, 1, "SAME")}[pool]
    j_dt, t_dt = CARRIERS[carrier]
    for shape in ((2, 12, 12, 8), (2, 11, 13, 8)):
        rng = np.random.default_rng(shape[1])
        x = np.maximum(rng.integers(-2, 3, shape), 0).astype(np.float32)
        x[0, 0, 0, 0] = 1.0   # ties
        jpool = JMaxPool(ksize=(k, k), strides=(s, s), padding=padding)

        def f(x):
            return jpool.apply({}, {}, None, x, JCtx(train=True))[0]

        xj = jnp.asarray(x).astype(j_dt)
        y, vjp = jax.vjp(f, xj)
        g = rng.normal(0, 1, y.shape).astype(np.float32)
        (dx,) = vjp(jnp.asarray(g).astype(j_dt))
        tx = torch.from_numpy(x).to(t_dt).requires_grad_()
        ty = MaxPool(ksize=(k, k), strides=(s, s), padding=padding)(tx, None)
        assert ty.dtype == t_dt
        np.testing.assert_array_equal(_to_np(ty),
                                      np.asarray(y.astype(jnp.float32)))
        ty.backward(torch.from_numpy(g).to(t_dt))
        want = np.asarray(dx.astype(jnp.float32))
        got = _to_np(tx.grad)
        assert (want != 0).sum() > 0
        if carrier == "f32":
            np.testing.assert_array_equal(got, want)
        else:
            assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("carrier", sorted(CARRIERS))
@pytest.mark.parametrize("stride", [1, 2])
def test_residual_bottleneck_matches_lbt_tpu(stride, carrier):
    """One training forward and backward of a narrow bottleneck (cin 16,
    c 4: an identity shortcut at stride 1, a projection at stride 2)
    under the headline config: output, input and parameter gradients at
    TOL (f32) or rtol 1e-3, atol 1e-5 (bf16, as the ResNet-50 steps), the
    sinks and new exponents bitwise."""
    jcfg, tcfg = headline(carrier), headline(carrier, tconfig)
    jblock = jfinalize(JBottleneck("block", jcfg, 16, 4, stride))
    block = finalize(ResidualBottleneck("block", tcfg, 16, 4, stride))
    assert [c.uid for c in block.sublayers()] == [
        c.uid for c in jblock.children()]
    assert bool(block.shortcut.layers) == (stride == 2)
    rng = np.random.default_rng(stride)
    x = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    ho = 8 // stride
    g = (rng.normal(0, 1, (2, ho, ho, 16)) * 2.0 ** -6).astype(np.float32)
    want, got, _ = run_both(jblock, block, x, "train", carrier, g)
    tol = TOL if carrier == "f32" else dict(rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got["y"], want["y"], **tol)
    np.testing.assert_allclose(got["dx"], want["dx"], **tol)
    wgrads = _flat_grads(want["dp"])
    for name, path in _param_paths(block).items():
        np.testing.assert_allclose(got["dp"][name], wgrads[path],
                                   err_msg=path, **tol)
    wsinks = _flat_grads(want["ds"])
    for uid, path in _sink_paths(block).items():
        np.testing.assert_array_equal(got["ds"][uid], wsinks[f"{path}/grad"],
                                      err_msg=path)
    _compare_state(got["q"], want["q"])


def test_resnet50_f32_train_steps_match_lbt_tpu():
    """Three steps of ``imagenet_resnet(50)`` under the headline config
    with f32 carriers (``test_torch_imagenet.py`` for what and how)."""
    resnet50_steps_match_lbt_tpu("f32")
