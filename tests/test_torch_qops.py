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
