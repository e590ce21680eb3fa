"""K2's plain version and the port's qmatmul / qconv2d forwards held
against lbt_tpu, bitwise: integer sums times a power of two.

The Pallas GEMM runs in interpret mode; qmatmul / qconv2d are compared
with lbt_tpu's ``engine='int8'`` on the CPU, at ResNet-20's conv classes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lbt_tpu.ops import qops as jops
from lbt_tpu.ops.pallas.quant_kernels import matmul_int8_pallas
from lbt_tpu_torch.ops import qops
from lbt_tpu_torch.ops.kernels.gemm import int8_matmul, int8_matmul_plain

pytest_plugins = ["torch_suite"]


@pytest.mark.parametrize("mkn", [(130, 100, 70), (64, 27, 16), (128, 64, 10)])
def test_k2_plain_matches_matmul_int8_pallas(mkn):
    m, k, n = mkn
    rng = np.random.default_rng(sum(mkn))
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    inv = np.float32(2.0 ** -13)
    with pltpu.force_tpu_interpret_mode():
        want = matmul_int8_pallas(jnp.asarray(a), jnp.asarray(b),
                                  jnp.float32(inv))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = int8_matmul(ta, tb, torch.tensor([inv]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    raw = int8_matmul(ta, tb)
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(
        raw.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_k2_plain_is_exact_past_float32():
    """Sums above 2**24 stay exact: the plain version contracts in f64."""
    k = 1100
    a = torch.full((3, k), -128, dtype=torch.int8)
    b = torch.full((k, 2), -128, dtype=torch.int8)
    assert int8_matmul_plain(a, b)[0, 0].item() == 128 * 128 * k


def test_k2_checks_its_operands():
    a = torch.zeros(4, 6, dtype=torch.int8)
    with pytest.raises(ValueError):
        int8_matmul(a, torch.zeros(5, 3, dtype=torch.int8))
    with pytest.raises(ValueError):
        int8_matmul(a.float(), torch.zeros(6, 3))
    with pytest.raises(ValueError):
        int8_matmul(a, torch.zeros(3, 6, dtype=torch.int8).t())


@pytest.mark.parametrize("exps", [(2, 1), (-1, 0), (0, -2)])
def test_qmatmul_matches_lbt_tpu_int8(exps):
    ex, ew = exps
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1.5, (37, 64)).astype(np.float32)
    w = rng.normal(0, 0.4, (64, 10)).astype(np.float32)
    want = jops.qmatmul(jnp.asarray(x), jnp.asarray(w), jnp.int32(ex),
                        jnp.int32(ew), jnp.int32(0), bits_x=8, bits_w=8,
                        bits_g=8, engine="int8")
    got = qops.qmatmul(torch.from_numpy(x), torch.from_numpy(w), ex, ew,
                       bits_x=8, bits_w=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ResNet-20's conv classes: (x shape, kernel HWIO, stride)
CONV_CLASSES = {
    "3x3s1_c16": ((2, 8, 8, 16), (3, 3, 16, 16), 1),
    "3x3s2_even": ((2, 8, 8, 16), (3, 3, 16, 32), 2),
    "1x1s2_shortcut": ((2, 8, 8, 16), (1, 1, 16, 32), 2),
    "stem_cin3": ((2, 8, 8, 3), (3, 3, 3, 16), 1),
}


@pytest.mark.parametrize("bits_x", [8, 9])
@pytest.mark.parametrize("cls", sorted(CONV_CLASSES))
def test_qconv2d_matches_lbt_tpu_int8(cls, bits_x):
    xshape, wshape, s = CONV_CLASSES[cls]
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, xshape).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, wshape).astype(np.float32)
    for ex, ew in [(1, 0), (-1, -1)]:
        want = jops.qconv2d(
            jnp.asarray(x), jnp.asarray(w), jnp.int32(ex), jnp.int32(ew),
            jnp.int32(0), strides=(s, s), padding="SAME", bits_x=bits_x,
            bits_w=8, bits_g=8, engine="int8")
        got = qops.qconv2d(torch.from_numpy(x), torch.from_numpy(w), ex, ew,
                           strides=(s, s), padding="SAME", bits_x=bits_x,
                           bits_w=8)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{cls} exps={ex},{ew}")


def test_same_padding_is_asymmetric_at_stride_2():
    assert qops.conv_same_padding(32, 3, 2) == (0, 1)
    assert qops.conv_same_padding(32, 3, 1) == (1, 1)
    assert qops.conv_same_padding(32, 1, 2) == (0, 0)
    assert qops.conv_pads("VALID", (8, 8), (3, 3), (1, 1)) == ((0, 0),) * 2


@pytest.mark.parametrize("widths", [(10, 8), (9, 8), (8, 9), (32, 8)])
def test_qops_refuse_code_widths_beyond_the_int8_engine(widths):
    """Code widths past the int8 engine's, refused before the float
    fallback was ported, now take it: ``lbt_tpu``'s fake-quant route past
    9 bits or at 32 (f32 contraction), and its bf16 integer route for
    9-bit weights or dense operands, which the port contracts in f32.
    Forwards bitwise where both operands are on a grid (every sum here is
    exact in f32); at rtol 1e-5 with a 32-bit operand, whose f32 sums
    round in another order."""
    bits_x, bits_w = widths
    rng = np.random.default_rng(sum(widths))
    x = rng.normal(0, 1, (2, 6, 6, 3)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, 3, 4)).astype(np.float32)
    kw = dict(bits_x=bits_x, bits_w=bits_w)
    want = jops.qconv2d(jnp.asarray(x), jnp.asarray(w), jnp.int32(1),
                        jnp.int32(0), jnp.int32(0), strides=(1, 1),
                        padding="SAME", bits_g=8, engine="int8", **kw)
    got = qops.qconv2d(torch.from_numpy(x), torch.from_numpy(w), 1, 0,
                       strides=(1, 1), padding="SAME", **kw)
    tol = dict(rtol=0, atol=0) if bits_x < 32 else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    a, b = x.reshape(12, 18), w.reshape(27, 4)[:18]
    want = jops.qmatmul(jnp.asarray(a), jnp.asarray(b), jnp.int32(1),
                        jnp.int32(0), jnp.int32(0), bits_g=8,
                        engine="int8", **kw)
    got = qops.qmatmul(torch.from_numpy(a), torch.from_numpy(b), 1, 0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# the int8 conv backward's dgrad and wgrad against the im2col route they
# replace: (x shape, kernel HWIO, strides, padding, x code dtype)
CONV_BWD_CASES = {
    "1x1s1": ((2, 5, 5, 16), (1, 1, 16, 32), 1, "SAME", torch.int8),
    "1x1s2": ((2, 7, 7, 32), (1, 1, 32, 16), 2, "SAME", torch.int8),
    "3x3s1_7": ((2, 7, 7, 16), (3, 3, 16, 16), 1, "SAME", torch.int8),
    "3x3s2_7": ((2, 7, 7, 32), (3, 3, 32, 16), 2, "SAME", torch.int8),
    "3x3s2_15": ((1, 15, 15, 16), (3, 3, 16, 32), 2, "SAME", torch.int8),
    "7x7s2_16": ((1, 15, 15, 16), (7, 7, 16, 16), 2, "SAME", torch.int8),
    "5x5s2_valid_remainder": ((2, 12, 13, 16), (5, 5, 16, 16), 2, "VALID",
                              torch.int8),
    "5x5_pads_past_the_kernel": ((1, 6, 7, 16), (5, 5, 16, 16), 1,
                                 ((5, 6), (0, 6)), torch.int8),
    "3x3s2_split9": ((2, 7, 7, 16), (3, 3, 16, 32), 2, "SAME", torch.int16),
}


@pytest.mark.parametrize("case", sorted(CONV_BWD_CASES))
def test_conv_bwd_plain_matches_the_im2col_route(case):
    """``int8_conv_dgrad`` / ``int8_conv_wgrad`` (their plain versions on
    the CPU) equal the route they replace bit for bit (``_im2col_dgrad``,
    ``_im2col_wgrad``: K2 over im2col patches, K2's plain version on the
    CPU), dgrad with and without the dequantizing scale (the int32
    partial of a sharded layer), wgrad with int8 and split-9 codes."""
    from lbt_tpu_torch.ops.im2col import dx_pads
    from lbt_tpu_torch.ops.kernels.conv_bwd import (int8_conv_dgrad,
                                                    int8_conv_wgrad)
    xshape, wshape, s, padding, xdtype = CONV_BWD_CASES[case]
    kh, kw, cin, cout = wshape
    strides = (s, s)
    pads = qops.conv_pads(padding, xshape[1:3], (kh, kw), strides)
    ho, wo = qops.out_hw(*xshape[1:3], (kh, kw), strides, pads)
    if case == "5x5_pads_past_the_kernel":
        assert min(min(p) for p in dx_pads(
            xshape[1:3], (kh, kw), strides, pads, (ho, wo))) < 0
    g = torch.Generator().manual_seed(len(case))
    lim = 256 if xdtype == torch.int16 else 128
    xc = torch.randint(-lim, lim, xshape, generator=g, dtype=xdtype)
    wc = torch.randint(-128, 128, wshape, generator=g, dtype=torch.int8)
    gc = torch.randint(-128, 128, (xshape[0], ho, wo, cout), generator=g,
                       dtype=torch.int8)
    inv = torch.tensor([2.0 ** -13])

    for scale in (inv, None):
        got = int8_conv_dgrad(gc, wc, xshape[1:3], strides, pads, scale)
        want = qops._im2col_dgrad(gc, wc, xshape[1:3], strides, pads, scale)
        assert got.dtype == want.dtype and torch.equal(got, want)

    got = int8_conv_wgrad(xc, gc, (kh, kw), strides, pads)
    want = qops._im2col_wgrad(xc, gc, (kh, kw), strides, pads)
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_int8_train_step_gathers_conv_taps_in_place(monkeypatch):
    """One int8 ResNet-8 step under the headline's options: the convs
    whose channels are multiples of 16 go through the dgrad and wgrad
    wrappers (one call each a conv, none for the stem's dx), and
    ``im2col`` and ``dilate_pad`` run only for the RGB stem (its dW); the
    loss, parameters and velocity equal the im2col route's bit for bit."""
    import dataclasses

    from lbt_tpu_torch import convert
    from lbt_tpu_torch.config import QuantConfig, TrainConfig
    from lbt_tpu_torch.dfxp.keys import base_key
    from lbt_tpu_torch.models import cifar10_resnet
    from lbt_tpu_torch.train.optim import momentum_init
    from lbt_tpu_torch.train.step import make_train_step

    cfg = dataclasses.replace(
        QuantConfig.uniform(8, engine="int8", noise_mode="hash1"),
        fused_bn=True, act_dtype="bf16", conv_act_extra=0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (2,)))

    def step():
        model = cifar10_resnet(cfg, 8, weight_decay=2e-4).init(
            torch.Generator().manual_seed(0))
        vel = momentum_init(dict(model.net.named_parameters()))
        loss = make_train_step(model, TrainConfig())(
            model, vel, x, y, 0, 1e-2, base_key(3))["loss"]
        return loss, convert.to_jax_numpy(model, vel)

    calls = {"im2col": [], "dilate_pad": [], "dgrad": 0, "wgrad": 0}

    def counted(name, fn, channels):
        def wrapped(*args, **kwargs):
            if isinstance(calls[name], list):
                calls[name].append(channels(*args))
            else:
                calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    with monkeypatch.context() as m:
        for name, attr, channels in (
                ("im2col", "im2col", lambda t, *a: t.shape[-1]),
                ("dilate_pad", "dilate_pad", lambda t, *a: t.shape[-1]),
                ("dgrad", "int8_conv_dgrad", None),
                ("wgrad", "int8_conv_wgrad", None)):
            m.setattr(qops, attr, counted(name, getattr(qops, attr),
                                          channels))
        loss, state = step()
    # 9 convs: the stem, 6 3x3 and 2 1x1 shortcut convs
    assert calls["dgrad"] == 8 and calls["wgrad"] == 8
    assert calls["im2col"] == [3] and calls["dilate_pad"] == []

    with monkeypatch.context() as m:
        m.setattr(qops, "int8_conv_dgrad", qops._im2col_dgrad)
        m.setattr(qops, "int8_conv_wgrad", qops._im2col_wgrad)
        want_loss, want = step()
    assert torch.equal(loss, want_loss)

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(state, want):
        same(a, b)
