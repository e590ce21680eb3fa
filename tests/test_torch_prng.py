"""The port's ``noise_mode='prng'`` held against lbt_tpu on the CPU:
``jax.random.uniform``'s threefry stream, the codes of every noise stream
with and without ``noise_shared_axis0``, the fused conv's BN-site codes
under threefry, the cotangent barrier, and three train steps of a CIFAR
ResNet-8 under ``QuantConfig.uniform(8)`` (main.py's defaults: int8
engine, ``prng`` noise).

Noise and codes are compared bitwise; the train steps at the tolerances
of ``test_torch_train.compare_train_steps``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbt_tpu.config as jconfig
from lbt_tpu.dfxp.barrier import grad_quant_barrier as jbarrier
from lbt_tpu.ops import qops as jops
from lbt_tpu_torch.dfxp import quantize as tq
from lbt_tpu_torch.dfxp.barrier import grad_quant_barrier, make_sink
from lbt_tpu_torch.ops import qops
from lbt_tpu_torch.ops.kernels import quant
from lbt_tpu_torch.ops.kernels.conv_fused import (conv1x1_fused,
                                                  conv3x3_fused)
from test_torch_train import compare_train_steps, resnet_pair

pytest_plugins = ["torch_suite"]

jq = importlib.import_module("lbt_tpu.dfxp.quantize")


# raw key data of site keys as the layers fold them, and edge words
_KEYS = [(0, 0), (0, 7), (0xDEADBEEF, 0x12345678), (0xFFFFFFFF, 0x80000001)]


def _jkey(kd):
    return jax.random.wrap_key_data(np.asarray(kd, np.uint32))


def test_jax_draws_the_partitionable_threefry_stream():
    """The port's ``prng`` noise is JAX's partitionable threefry stream: a
    JAX that changed the stream would fail here, not in silence."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5, 9),
                                   (2, 16, 16, 33), (65537,), (3, 70001)])
def test_threefry_uniform_matches_jax_random_uniform(shape):
    """``threefry_uniform_flat`` equals ``jax.random.uniform(key, shape,
    float32)`` bit for bit: odd sizes, n > 2**16, a 0-d shape (the large
    sizes under one key, which keeps JAX's compiles few)."""
    n = int(np.prod(shape))
    for kd in _KEYS if n < 2 ** 16 else _KEYS[2:3]:
        want = np.asarray(jax.random.uniform(_jkey(kd), shape, jnp.float32))
        got = quant.threefry_uniform_flat(*kd, n).numpy().reshape(shape)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=str(kd))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("backend", ["xla", "xla_hash", "xla_hash1"])
@pytest.mark.parametrize("bits", [4, 8, 9, 16])
def test_quantize_int_codes_match_lbt_tpu(bits, backend, shared):
    """Stochastic codes of ``quantize_int`` equal ``lbt_tpu``'s bitwise for
    each noise stream, per element and drawn once along axis 0."""
    rng = np.random.default_rng(bits)
    for shape in [(5,), (4, 6, 6, 16)]:
        x = rng.normal(0, 2, shape).astype(np.float32)
        for kd in _KEYS[1:3]:
            want, wm = jq.quantize_int(
                jnp.asarray(x), bits, jnp.int32(1), _jkey(kd),
                stochastic=True, backend=backend, noise_shared_axis0=shared)
            got, gm = tq.quantize_int(
                torch.from_numpy(x), bits, 1, kd, stochastic=True,
                backend=backend, noise_shared_axis0=shared)
            np.testing.assert_array_equal(
                got.numpy().astype(np.int32),
                np.asarray(want, np.float32).astype(np.int32),
                err_msg=f"{shape} {kd}")
            assert gm.item() == float(wm)


def test_noise_spec_names_each_stream():
    kd = (0xDEADBEEF, 0x12345678)
    assert tq.noise_spec(kd, False, "xla", (4, 4)) is None
    assert tq.noise_spec(kd, True, "xla", (4, 5)) == quant.Noise(
        quant.THREEFRY, *kd, 0)
    assert tq.noise_spec(kd, True, "xla_hash1", (4, 5), True) == \
        quant.Noise(quant.HASH1, tq.key_seed(kd), 0, 5)
    assert tq.noise_spec(kd, True, "xla_hash", (6,), True).inner == 1
    with pytest.raises(ValueError):
        tq.noise_spec(None, True, "xla", (4,))


# conv -> BN input shapes: (x, HWIO, stride, bits_x)
_CONVS = {"3x3_s1": ((2, 8, 8, 16), (3, 3, 16, 32), 1, 9),
          "3x3_s2": ((2, 9, 9, 16), (3, 3, 16, 16), 2, 8),
          "1x1_s2": ((2, 8, 8, 32), (1, 1, 32, 64), 2, 9)}


@pytest.mark.parametrize("case,shared", [("3x3_s1", False),
                                         ("3x3_s2", True), ("1x1_s2", True)])
def test_conv_fused_plain_threefry_matches_lbt_tpu(case, shared):
    """#4 / #5's plain version under threefry noise equals ``lbt_tpu``'s
    ``qconv2d`` then ``quantize_int(..., backend='xla')`` at the BN site's
    key, bitwise: codes and their moments."""
    xshape, wshape, s, bits_x = _CONVS[case]
    rng = np.random.default_rng(len(case) + s)
    x = rng.normal(0, 1, xshape).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, wshape).astype(np.float32)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(5), 4), 0)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    y = jops.qconv2d(jnp.asarray(x), jnp.asarray(w), jnp.int32(1),
                     jnp.int32(-1), jnp.int32(0), strides=(s, s),
                     padding="SAME", bits_x=bits_x, bits_w=8, bits_g=8,
                     engine="int8")
    want, _ = jq.quantize_int(y, 8, jnp.int32(2), key, stochastic=True,
                              backend="xla", noise_shared_axis0=shared)
    want = np.asarray(want).astype(np.int64)

    xc, mx = tq.quantize_int(torch.from_numpy(x), bits_x, 1)
    wc, mw = tq.quantize_int(torch.from_numpy(w), 8, -1)
    fused = conv3x3_fused if wshape[0] == 3 else conv1x1_fused
    codes, moments, _ = fused(
        xc, wc, (1.0 / (mx * mw)).reshape(1),
        tq.multiplier(8, 2).reshape(1), strides=(s, s),
        pads=qops.conv_pads("SAME", xshape[1:3], wshape[:2], (s, s)),
        noise=tq.noise_spec(kd, True, "xla", want.shape, shared))
    np.testing.assert_array_equal(codes.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(
        moments.numpy(), [want.sum((0, 1, 2)), (want ** 2).sum((0, 1, 2))])


@pytest.mark.parametrize("shared", [False, True])
def test_barrier_prng_matches_lbt_tpu(shared):
    """The cotangent barrier under threefry noise: the quantized cotangent
    and its overflow statistics equal ``lbt_tpu``'s bitwise."""
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (4, 5, 6)).astype(np.float32)
    g = rng.normal(0, 0.3, x.shape).astype(np.float32)
    kd = (0x1234, 0xABCDEF)
    sink = jnp.zeros((2,), jnp.float32)

    def f(x, sink):
        return jnp.sum(jbarrier(x, 8, jnp.int32(-1), sink, _jkey(kd),
                                stochastic=True, backend="xla",
                                noise_shared_axis0=shared) * g)

    want_dx, want_stats = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), sink)
    xt = torch.from_numpy(x).requires_grad_(True)
    tsink = make_sink()
    y = grad_quant_barrier(xt, 8, -1, tsink, kd, stochastic=True,
                           backend="xla", noise_shared_axis0=shared)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))
    np.testing.assert_array_equal(tsink.grad.numpy(), np.asarray(want_stats))


def test_resnet8_int8_prng_train_steps_match_lbt_tpu():
    """Three steps of ResNet-8 under ``uniform(8)``: the int8 engine with
    main.py's default ``prng`` noise (K1 and #4/#5 in threefry mode on the
    card), against lbt_tpu's jitted step."""
    compare_train_steps(*resnet_pair(jconfig.QuantConfig.uniform(8)))
