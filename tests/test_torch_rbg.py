"""The port's ``noise_impl='unsafe_rbg'`` held against JAX and lbt_tpu on
the CPU.

Off the TPU, XLA's ``rng_bit_generator`` is the Philox4x32-10 stream, so
``lbt_tpu`` under an ``unsafe_rbg`` key draws a fixed, reproducible
stream, and the port draws the same one (``dfxp/keys.py``,
``ops/kernels/quant.py:rbg_uniform_flat``, mode 4 of K1 and #4/#5):

- the bits against ``jax.lax.rng_bit_generator`` (Random123's known
  answer, ragged sizes, 2-D and 4-D shapes, a counter that carries past
  2**64), and the key chain against ``jax.random`` (``key``, ``fold_in``,
  ``split``, the site keys, the Trainer's data and eval keys, the DP
  rank's key), with the XOR symmetry of its ``fold_in``;
- the uniforms against ``jax.random.uniform`` (whole, shared along axis
  0, a row offset, a column window);
- against ``lbt_tpu`` under 4-word keys: ``quantize_int``'s codes, the
  fused conv's plain version, the cotangent barrier, the Dropout mask,
  the augmentation's draws;
- three ResNet-8 train steps under ``benchmarks/ablate.py``'s
  ``rbg-int8`` (``uniform(8, engine='int8', noise_mode='prng',
  noise_impl='unsafe_rbg')``) at the tolerances of
  ``test_torch_train.compare_train_steps``.

Everything but the train steps is compared bitwise.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbt_tpu.config as jconfig
from lbt_tpu.data.datasets import _augment_crop_flip
from lbt_tpu.dfxp.barrier import grad_quant_barrier as jbarrier
from lbt_tpu.nn import layers as jlayers
from lbt_tpu.nn.core import Ctx as JCtx
from lbt_tpu.ops import qops as jops
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch.data.datasets import augment_crop_flip, augment_draws
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.dfxp import quantize as tq
from lbt_tpu_torch.dfxp.barrier import grad_quant_barrier, make_sink
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.nn import layers as tlayers
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.ops import qops
from lbt_tpu_torch.ops.kernels import quant
from lbt_tpu_torch.ops.kernels.conv_fused import (conv1x1_fused,
                                                  conv3x3_fused)
from lbt_tpu_torch.train.trainer import (DATA_KEY_FOLD, EVAL_KEY_FOLD,
                                         Trainer)
from test_torch_train import compare_train_steps, resnet_pair

pytest_plugins = ["torch_suite"]

jq = importlib.import_module("lbt_tpu.dfxp.quantize")

RBG = "unsafe_rbg"
# raw unsafe_rbg key data: zeros, a seed's, words at the edges, and one
# whose low counter half s1 = k2 | k3 << 32 carries past 2**64 within a
# few blocks
_KEYS = [(0, 0, 0, 0), (0, 7, 0, 7), (0xDEADBEEF, 0x12345678, 0x9ABCDEF0,
                                      0x0FEDCBA9),
         (0x80000001, 0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF)]


def _jkey(kd):
    return jax.random.wrap_key_data(np.asarray(kd, np.uint32), impl=RBG)


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key), np.uint32)


# ---------------------------------------------------------------------------
# the bits and the key chain
# ---------------------------------------------------------------------------


def test_philox_known_answer():
    """Random123's known answer for Philox4x32-10 at key 0 and counter
    0."""
    np.testing.assert_array_equal(
        keys.philox4x32_10(np.zeros(2, np.uint32), np.zeros(4, np.uint32)),
        np.array([0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
                 np.uint32))


@pytest.mark.parametrize("shape", [(1,), (3,), (13,), (40,), (5, 7),
                                   (2, 3, 4, 5), (257, 65)])
def test_rbg_bits_match_rng_bit_generator(shape):
    """``rbg_bits`` equals ``lax.rng_bit_generator``'s uint32 bits, row
    major over the shape: sizes not a multiple of 4, 2-D and 4-D shapes,
    and the last key, whose counter carries past 2**64."""
    n = int(np.prod(shape))
    for kd in _KEYS:
        _, want = jax.lax.rng_bit_generator(
            jnp.asarray(kd, jnp.uint32), shape, dtype=jnp.uint32)
        np.testing.assert_array_equal(keys.rbg_bits(kd, n),
                                      np.asarray(want).ravel(),
                                      err_msg=str(kd))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_key_chain_matches_jax(seed):
    """``base_key``, ``fold_in``, ``split`` and the site keys under
    ``impl='unsafe_rbg'`` equal ``jax.random``'s key data bitwise."""
    base = jax.random.key(seed, impl=RBG)
    np.testing.assert_array_equal(keys.base_key(seed, RBG), _kd(base))
    for data in (0, 3, 9, DATA_KEY_FOLD, 123456789, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            keys.fold_in(keys.base_key(seed, RBG), data),
            _kd(jax.random.fold_in(base, np.uint32(data))))
    for n in (1, 2, 3, 5):
        np.testing.assert_array_equal(keys.split(_kd(base), n),
                                      _kd(jax.random.split(base, n)))
    step = jax.random.fold_in(base, 11)
    table = keys.site_keys(_kd(step), 7, 5)
    assert table.shape == (7, 5, 4)
    for uid in range(7):
        for site in range(5):
            np.testing.assert_array_equal(
                table[uid, site], _kd(jax.random.fold_in(
                    jax.random.fold_in(step, uid), site)))


def test_fold_in_is_an_xor():
    """Under ``unsafe_rbg`` ``fold_in(k, d)`` is ``k ^ r(d)``: two folds
    commute and a fold twice is none, in JAX as in the port.  So the
    layer whose uid equals the step number draws the same site keys at
    every step (ROADMAP, kept as in ``lbt_tpu``)."""
    k = jax.random.key(5, impl=RBG)
    ab = jax.random.fold_in(jax.random.fold_in(k, 1), 2)
    ba = jax.random.fold_in(jax.random.fold_in(k, 2), 1)
    np.testing.assert_array_equal(_kd(ab), _kd(ba))
    np.testing.assert_array_equal(
        _kd(jax.random.fold_in(jax.random.fold_in(k, 3), 3)), _kd(k))
    t = keys.base_key(5, RBG)
    np.testing.assert_array_equal(
        keys.fold_in(keys.fold_in(t, 1), 2), _kd(ab))
    np.testing.assert_array_equal(keys.fold_in(keys.fold_in(t, 3), 3), t)
    # step 4's key at uid 6 is step 6's at uid 4
    np.testing.assert_array_equal(
        keys.site_keys(keys.fold_in(t, 4), 7, 5)[6],
        keys.site_keys(keys.fold_in(t, 6), 7, 5)[4])


def test_trainer_and_dp_keys_match_lbt_tpu():
    """The Trainer's base, data and eval keys and the DP step's rank key
    under ``noise_impl='unsafe_rbg'``: ``lbt_tpu/train/trainer.py:112-116``
    (``key(seed, impl)``, ``split(fold_in(base, 0xA11CE))[1]``), ``:385``
    (``fold_in(base, 0xE7A1)``) and ``lbt_tpu/parallel/dp.py:74-75``
    (``fold_in(fold_in(base, step), rank)``)."""
    seed = 3
    cfg = tconfig.QuantConfig.uniform(8, noise_impl=RBG)
    data = {"train": (np.zeros((4, 32, 32, 3), np.float32),
                      np.zeros(4, np.int32)),
            "test": (np.zeros((4, 32, 32, 3), np.float32),
                     np.zeros(4, np.int32))}
    tr = Trainer(cifar10_resnet(cfg, 8), tconfig.TrainConfig(
        batch_size=4, n_epoch=1, seed=seed), data, device="cpu")
    base = jax.random.key(seed, impl=RBG)
    np.testing.assert_array_equal(tr.base_key, _kd(base))
    _, want_data = jax.random.split(jax.random.fold_in(base, DATA_KEY_FOLD))
    np.testing.assert_array_equal(tr.data_key, _kd(want_data))
    np.testing.assert_array_equal(
        keys.fold_in(tr.base_key, EVAL_KEY_FOLD),
        _kd(jax.random.fold_in(base, EVAL_KEY_FOLD)))
    for step, rank in ((0, 1), (5, 3)):
        np.testing.assert_array_equal(
            keys.fold_in(keys.fold_in(tr.base_key, step), rank),
            _kd(jax.random.fold_in(jax.random.fold_in(base, step), rank)))


# ---------------------------------------------------------------------------
# the uniforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5, 9),
                                   (2, 16, 16, 33), (3, 70001)])
def test_rbg_uniform_matches_jax_random_uniform(shape):
    """``rbg_uniform_flat`` equals ``jax.random.uniform(key, shape,
    float32)`` under an unsafe_rbg key bit for bit (the large shape under
    one key, which keeps JAX's compiles few)."""
    n = int(np.prod(shape))
    for kd in _KEYS if n < 2 ** 16 else _KEYS[2:3]:
        want = np.asarray(jax.random.uniform(_jkey(kd), shape, jnp.float32))
        got = quant.rbg_uniform_flat(kd, n).numpy().reshape(shape)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=str(kd))


def test_rbg_uniform_shared_offset_and_window():
    """A draw of ``shape[1:]`` shared along axis 0 (``inner``), rows
    ``2..`` of a tensor (a row ``offset``, odd and not a multiple of 4),
    and columns ``2..4`` of every row (a ``window``, alone and with the
    offset): each equal to its slice of ``jax.random.uniform``'s whole
    draw."""
    rows, cols = 6, 7
    for kd in _KEYS[1:]:
        whole = np.asarray(jax.random.uniform(_jkey(kd), (rows, cols)))
        inner = np.asarray(jax.random.uniform(_jkey(kd), (cols,)))
        np.testing.assert_array_equal(
            quant.rbg_uniform_flat(kd, rows * cols, inner=cols).numpy(),
            np.broadcast_to(inner, (rows, cols)).ravel())
        np.testing.assert_array_equal(
            quant.rbg_uniform_flat(kd, 4 * cols, offset=2 * cols).numpy(),
            whole[2:].ravel())
        np.testing.assert_array_equal(
            quant.rbg_uniform_flat(kd, rows * 3, window=(3, cols, 2))
            .numpy(), whole[:, 2:5].ravel())
        np.testing.assert_array_equal(
            quant.rbg_uniform_flat(kd, 3 * 3, offset=3 * cols,
                                   window=(3, cols, 2)).numpy(),
            whole[3:, 2:5].ravel())


# ---------------------------------------------------------------------------
# against lbt_tpu under 4-word keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("backend", ["xla", "xla_hash", "xla_hash1"])
@pytest.mark.parametrize("bits", [4, 8, 9, 16])
def test_quantize_int_codes_match_lbt_tpu(bits, backend, shared):
    """Stochastic codes of ``quantize_int`` under unsafe_rbg keys equal
    ``lbt_tpu``'s bitwise: ``prng`` draws the Philox stream (mode 4), the
    hashes seed from the key's first and last words."""
    rng = np.random.default_rng(bits)
    for shape in [(5,), (4, 6, 6, 16)]:
        x = rng.normal(0, 2, shape).astype(np.float32)
        for kd in _KEYS[2:]:
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


def test_noise_spec_under_a_four_word_key():
    kd = _KEYS[2]
    assert tq.noise_spec(kd, True, "xla", (4, 5)) == quant.Noise(
        quant.RBG, kd[0], kd[1], 0, 0, 0, 0, kd[2], kd[3])
    assert tq.noise_spec(kd, True, "pallas", (4, 5), True).inner == 5
    assert tq.noise_spec(kd, True, "xla_hash", (4, 5)) == quant.Noise(
        quant.HASH, tq.key_seed(kd), 0)
    with pytest.raises(ValueError):
        tq.noise_spec(kd[:3], True, "xla", (4,))


# conv -> BN input shapes: (x, HWIO, stride, bits_x)
_CONVS = {"3x3_s1": ((2, 8, 8, 16), (3, 3, 16, 32), 1, 9),
          "3x3_s2": ((2, 9, 9, 16), (3, 3, 16, 16), 2, 8),
          "1x1_s2": ((2, 8, 8, 32), (1, 1, 32, 64), 2, 9)}


@pytest.mark.parametrize("case,shared", [("3x3_s1", False),
                                         ("3x3_s2", True), ("1x1_s2", True)])
def test_conv_fused_plain_rbg_matches_lbt_tpu(case, shared):
    """#4 / #5's plain version under an unsafe_rbg site key equals
    ``lbt_tpu``'s ``qconv2d`` then ``quantize_int(..., backend='xla')``,
    bitwise: codes and their moments."""
    xshape, wshape, s, bits_x = _CONVS[case]
    rng = np.random.default_rng(len(case) + s)
    x = rng.normal(0, 1, xshape).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, wshape).astype(np.float32)
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.key(5, impl=RBG), 4), 0)
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
        noise=tq.noise_spec(_kd(key), True, "xla", want.shape, shared))
    np.testing.assert_array_equal(codes.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(
        moments.numpy(), [want.sum((0, 1, 2)), (want ** 2).sum((0, 1, 2))])


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("shared", [False, True])
def test_barrier_rbg_matches_lbt_tpu(shared, gate):
    """The cotangent barrier under an unsafe_rbg key: the quantized
    cotangent and its overflow statistics (the hold sentinel with the
    controllers gated off) equal ``lbt_tpu``'s bitwise."""
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (4, 5, 6)).astype(np.float32)
    g = rng.normal(0, 0.3, x.shape).astype(np.float32)
    kd = _KEYS[2]
    sink = jnp.zeros((2,), jnp.float32)

    def f(x, sink):
        return jnp.sum(jbarrier(x, 8, jnp.int32(-1), sink, _jkey(kd),
                                stochastic=True, backend="xla",
                                noise_shared_axis0=shared,
                                gate=gate) * g)

    want_dx, want_stats = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), sink)
    xt = torch.from_numpy(x).requires_grad_(True)
    tsink = make_sink()
    y = grad_quant_barrier(xt, 8, -1, tsink, kd, stochastic=True,
                           backend="xla", noise_shared_axis0=shared,
                           gate=gate)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))
    np.testing.assert_array_equal(tsink.grad.numpy(), np.asarray(want_stats))


@pytest.mark.parametrize("keep", [0.5, 0.8])
def test_dropout_rbg_matches_lbt_tpu(keep):
    """Dropout's mask and output under an unsafe_rbg step key equal
    ``lbt_tpu``'s (``jax.random.bernoulli`` of the site-4 key), and rows
    ``2..`` of a data-parallel eval rank (``Ctx.row0``) draw the whole
    batch's mask there."""
    x = np.random.default_rng(3).normal(0, 1, (4, 5, 6, 7)).astype(
        np.float32)
    key = jax.random.key(11, impl=RBG)
    jl, tl = jlayers.Dropout(keep=keep), tlayers.Dropout(keep=keep)
    jl.uid = tl.uid = 9
    want, _ = jl.apply({}, {}, {}, jnp.asarray(x), JCtx(train=True, key=key))
    want = np.asarray(want)
    got = tl(torch.from_numpy(x), Ctx(train=True, key=_kd(key)))
    np.testing.assert_array_equal(got.numpy(), want)
    mask = np.asarray(jax.random.bernoulli(
        jax.random.fold_in(jax.random.fold_in(key, 9), 4), keep, x.shape))
    np.testing.assert_array_equal(got.numpy() != 0, mask & (x != 0))
    rows = tl(torch.from_numpy(x[2:]), Ctx(train=True, key=_kd(key), row0=2))
    np.testing.assert_array_equal(rows.numpy(), want[2:])


@pytest.mark.parametrize("pad", [4, 16])
def test_augment_draws_match_lbt_tpu(pad):
    """Under an unsafe_rbg key the augmentation's draws are ``lbt_tpu``'s
    (``split(key, 3)``, ``bernoulli(kf, 0.5)``, ``randint(kh / kw, 0,
    2*pad + 1)``), so the flipped and cropped batch equals
    ``_augment_crop_flip``'s bitwise, and a data-parallel rank's rows take
    the global batch's draws."""
    x = np.random.default_rng(0).normal(size=(16, 8, 8, 3)).astype(
        np.float32)
    for step in range(3):
        key = jax.random.fold_in(jax.random.key(2, impl=RBG), step)
        kf, kh, kw = jax.random.split(key, 3)
        flip, oh, ow = augment_draws(_kd(key), 16, pad)
        np.testing.assert_array_equal(
            flip, np.asarray(jax.random.bernoulli(kf, 0.5, (16,))))
        np.testing.assert_array_equal(
            oh, np.asarray(jax.random.randint(kh, (16,), 0, 2 * pad + 1)))
        np.testing.assert_array_equal(
            ow, np.asarray(jax.random.randint(kw, (16,), 0, 2 * pad + 1)))
        want = np.asarray(_augment_crop_flip(key, jnp.asarray(x), pad))
        np.testing.assert_array_equal(
            augment_crop_flip(_kd(key), torch.from_numpy(x), pad).numpy(),
            want)
        np.testing.assert_array_equal(
            augment_crop_flip(_kd(key), torch.from_numpy(x[5:9]), pad,
                              rows=(5, 16)).numpy(), want[5:9])


def test_resnet8_rbg_int8_train_steps_match_lbt_tpu():
    """Three steps of ResNet-8 under ``benchmarks/ablate.py:90-91``'s
    ``rbg-int8`` (int8 engine, ``prng`` noise, ``unsafe_rbg`` keys: K1
    and #4/#5 in mode 4 on the card) against lbt_tpu's jitted step, at
    the tolerances of ``test_resnet8_int8_prng_train_steps_match_lbt_tpu``
    (:func:`compare_train_steps`): exponents bitwise every step."""
    compare_train_steps(*resnet_pair(jconfig.QuantConfig.uniform(
        8, engine="int8", noise_mode="prng", noise_impl=RBG)))
