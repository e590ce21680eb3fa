"""Kernels #4 / #5 (conv fused with the BN input site's epilogue): their
plain PyTorch version held against the Pallas kernels in interpret mode
(as tests/test_pallas.py runs them) and against lbt_tpu's unfused
composition at ResNet-20's shapes; the port's fused training route held
against its unfused route.

Codes, moments and exponents are compared bitwise; the Pallas kernels'
f32 moments and min / max at rtol 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lbt_tpu.ops import qops as jops
from lbt_tpu.ops.pallas.conv1x1_kernels import conv1x1_fused_int8
from lbt_tpu.ops.pallas.conv_kernels import conv3x3_fused_int8
from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.dfxp import quantize as tq
from lbt_tpu_torch.nn.blocks import ResidualBlock
from lbt_tpu_torch.nn.core import Ctx, Sequential, finalize, make_sinks
from lbt_tpu_torch.nn.layers import Conv2d
from lbt_tpu_torch.nn import norm as norm_module
from lbt_tpu_torch.nn.norm import BatchNorm
from lbt_tpu_torch.ops import qops
from lbt_tpu_torch.ops.kernels.conv_fused import (conv1x1_fused,
                                                  conv3x3_fused)

jq = importlib.import_module("lbt_tpu.dfxp.quantize")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_plain_3x3_matches_conv3x3_fused_int8():
    rng = np.random.default_rng(3)
    b, h, w, c, k = 2, 6, 7, 128, 128
    xq = rng.integers(-8, 8, (b, h, w, c)).astype(np.int8)
    wq = rng.integers(-8, 8, (3, 3, c, k)).astype(np.int8)
    inv, mult = 1.0 / 1024.0, 32.0
    with pltpu.force_tpu_interpret_mode():
        yq, mom, mm = conv3x3_fused_int8(
            jnp.asarray(xq), jnp.asarray(wq), jnp.float32(inv),
            jnp.float32(mult), jnp.int32(0), bits_out=8, stochastic=False)
    codes, moments, minmax = conv3x3_fused(
        _t(xq), _t(wq), torch.tensor([inv]), torch.tensor([mult]),
        strides=(1, 1), pads=((1, 1), (1, 1)))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(yq))
    np.testing.assert_allclose(moments.numpy(), np.asarray(mom), rtol=1e-6)
    np.testing.assert_allclose(minmax.numpy(), np.asarray(mm), rtol=1e-6)


@pytest.mark.parametrize("rails", [False, True])
def test_plain_1x1_matches_conv1x1_fused_int8(rails):
    """Including codes driven past both rails (round of clip: -128)."""
    rng = np.random.default_rng(0)
    if rails:
        xq = rng.integers(-30, 30, (2, 4, 4, 128)).astype(np.int8)
        wq = rng.integers(-3, 4, (128, 128)).astype(np.int8)
        inv, mult = 1.0, 8.0
    else:
        xq = rng.integers(-8, 8, (2, 9, 9, 64)).astype(np.int8)
        wq = rng.integers(-2, 3, (64, 128)).astype(np.int8)
        inv, mult = 1.0 / 1024.0, 64.0
    with pltpu.force_tpu_interpret_mode():
        yq, mom, mm = conv1x1_fused_int8(
            jnp.asarray(xq), jnp.asarray(wq), jnp.float32(inv),
            jnp.float32(mult), jnp.int32(3), stochastic=False, tile_m=128)
    codes, moments, minmax = conv1x1_fused(
        _t(xq), _t(wq.reshape(1, 1, *wq.shape)), torch.tensor([inv]),
        torch.tensor([mult]), strides=(1, 1), pads=((0, 0), (0, 0)))
    if rails:
        assert (codes == -128).any() and (codes == 127).any()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(yq))
    np.testing.assert_allclose(moments.numpy(), np.asarray(mom), rtol=1e-6)
    np.testing.assert_allclose(minmax.numpy(), np.asarray(mm), rtol=1e-6)


# ResNet-20's conv -> BN input shapes at batch 2: (x, HWIO, stride, bits_x)
RESNET20 = {
    "stem": ((2, 32, 32, 3), (3, 3, 3, 16), 1, 9),
    "s1_16": ((2, 32, 32, 16), (3, 3, 16, 16), 1, 9),
    "s2_16_32": ((2, 32, 32, 16), (3, 3, 16, 32), 2, 9),
    "s1_32": ((2, 16, 16, 32), (3, 3, 32, 32), 1, 9),
    "s2_32_64": ((2, 16, 16, 32), (3, 3, 32, 64), 2, 9),
    "s1_64": ((2, 8, 8, 64), (3, 3, 64, 64), 1, 9),
    "short_16_32": ((2, 32, 32, 16), (1, 1, 16, 32), 2, 9),
    "short_32_64": ((2, 16, 16, 32), (1, 1, 32, 64), 2, 9),
    "s1_16_a8": ((2, 32, 32, 16), (3, 3, 16, 16), 1, 8),
}


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("case", sorted(RESNET20))
def test_plain_matches_lbt_tpu_unfused_composition(case, stochastic):
    """conv -> BN input quantize as lbt_tpu runs it unfused
    (``qconv2d`` then ``quantize_int(..., backend='xla_hash')`` at the BN
    site's key) against the port's fused route on the same codes.  The
    threefry noise (``backend='xla'``) is held the same way in
    ``tests/test_torch_prng.py``."""
    xshape, wshape, s, bits_x = RESNET20[case]
    rng = np.random.default_rng(sum(wshape) + s)
    x = rng.normal(0, 1, xshape).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, wshape).astype(np.float32)
    exp_x, exp_w, exp_out = 1, -1, 2
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(5), 4), 0)
    y = jops.qconv2d(jnp.asarray(x), jnp.asarray(w), jnp.int32(exp_x),
                     jnp.int32(exp_w), jnp.int32(0), strides=(s, s),
                     padding="SAME", bits_x=bits_x, bits_w=8, bits_g=8,
                     engine="int8")
    want, _ = jq.quantize_int(y, 8, jnp.int32(exp_out),
                              key if stochastic else None,
                              stochastic=stochastic, backend="xla_hash")
    want = np.asarray(want).astype(np.int64)

    xc, mx = tq.quantize_int(_t(x), bits_x, exp_x)
    wc, mw = tq.quantize_int(_t(w), 8, exp_w)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    fused = conv3x3_fused if wshape[0] == 3 else conv1x1_fused
    codes, moments, minmax = fused(
        xc, wc, (1.0 / (mx * mw)).reshape(1),
        tq.multiplier(8, exp_out).reshape(1), strides=(s, s),
        pads=qops.conv_pads("SAME", xshape[1:3], wshape[:2], (s, s)),
        noise=tq.noise_spec(kd, stochastic, "xla_hash", want.shape))
    np.testing.assert_array_equal(codes.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(
        moments.numpy(), [want.sum((0, 1, 2)), (want ** 2).sum((0, 1, 2))])
    np.testing.assert_array_equal(minmax.numpy(),
                                  [np.asarray(y).min(), np.asarray(y).max()])


def test_plain_stochastic_codes_are_unbiased():
    """E[floor(y*m + u)] = y*m for the hash noise: the mean over 64 seeds
    lies near the scaled conv output (a [-0.5, 0.5) noise bug would shift
    every element by half a code)."""
    rng = np.random.default_rng(2)
    xc = _t(rng.integers(-8, 8, (1, 4, 4, 32)).astype(np.int8))
    wc = _t(rng.integers(-2, 3, (1, 1, 32, 32)).astype(np.int8))
    inv, mult = torch.tensor([1.0 / 64]), torch.tensor([4.0])
    pads = ((0, 0), (0, 0))
    acc = torch.zeros(1, 4, 4, 32, dtype=torch.float64)
    for seed in range(64):
        acc += conv1x1_fused(xc, wc, inv, mult, strides=(1, 1), pads=pads,
                             noise=tq.Noise(1, seed * 7919))[0]
    scaled = ((qops.im2col(xc, (1, 1), (1, 1), pads).double()
               @ wc.reshape(32, 32).double()) * (4.0 / 64)).view_as(acc)
    mean = acc / 64
    assert (mean - scaled).abs().max() < 0.4
    assert abs((mean - scaled).mean().item()) < 0.1


def _route_outputs(layer, x, seed=9):
    """Forward and backward of ``layer`` in training with every sink;
    returns what both routes must agree on."""
    sinks = make_sinks(layer)
    ctx = Ctx(train=True, key=np.array([seed, 2 * seed], np.uint32),
              sinks=dict(sinks))
    tx = x.clone().requires_grad_()
    y = layer(tx, ctx)
    g = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1e-3, y.shape).astype(np.float32))
    y.backward(g)
    out = {"y": y.detach(), "dx": tx.grad}
    out.update({f"grad:{k}": p.grad.clone()
                for k, p in layer.named_parameters()})
    out.update({f"sink:{k}": s.grad for k, s in sinks.items()})
    out.update({f"staged:{i}": v for i, (_, v) in enumerate(ctx._staged)})
    for p in layer.parameters():
        p.grad = None
    return out


@pytest.mark.parametrize("block", ["stem", "stride2_block"])
def test_fused_route_matches_unfused_route(block, monkeypatch):
    cfg = QuantConfig.uniform(8, noise_mode="hash")
    gen = torch.Generator().manual_seed(4)
    if block == "stem":
        layer = finalize(Sequential("net", [
            Conv2d("conv1", cfg, (3, 3, 3, 16), use_bias=False),
            BatchNorm("conv1-bn", cfg, 16)]))
        x = torch.randn(2, 16, 16, 3, generator=gen)
    else:
        layer = finalize(ResidualBlock("block", cfg, 16, 32, stride=2))
        x = torch.randn(2, 16, 16, 16, generator=gen)
    for m in layer.modules():
        if hasattr(m, "reset_parameters") and m is not layer:
            m.reset_parameters(gen)
    calls = []
    monkeypatch.setattr(norm_module, "qconv2d_bn_input",
                        lambda *a, **k: calls.append(1) or
                        qops.qconv2d_bn_input(*a, **k))
    fused = _route_outputs(layer, x)
    assert len(calls) == (1 if block == "stem" else 3)
    # the unfused route: Conv2d.forward, then Normalization.forward
    monkeypatch.setattr(BatchNorm, "fuses_with", lambda self, layer: False)
    plain = _route_outputs(layer, x)
    assert len(calls) == (1 if block == "stem" else 3)
    assert fused.keys() == plain.keys()
    for k in fused:
        assert torch.equal(fused[k], plain[k]), k


def test_fused_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(1, 4, 4, 16, dtype=torch.int8, device="meta")
    one = torch.ones(1, device="meta")
    for fn, k in ((conv3x3_fused, 3), (conv1x1_fused, 1)):
        w = torch.empty(k, k, 16, 16, dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="no fused conv kernel"):
            fn(x, w, one, one, strides=(1, 1), pads=((0, 0), (0, 0)))
    with pytest.raises(ValueError, match="int8"):
        conv3x3_fused(x.float(), w, one, one, strides=(1, 1),
                      pads=((0, 0), (0, 0)))
