"""The port's deployment path held against lbt_tpu on the CPU: BatchNorm
folding (fp32, unfused and fused BN, a biased conv), the export of integer
weight codes (int8 and nibble-packed int4, odd sizes), its restore and
size, and the ``Predictor`` serving a checkpoint of the port's Trainer
(with BN folded) and a restored export.

Folded weights and biases at rtol 1e-6 and their exponents equal; codes,
packed bytes, restored weights and byte counts bitwise; served logits of
the same weights through two routes bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbt_tpu.config as jconfig
import lbt_tpu.infer as jinfer
import lbt_tpu.models.zoo as jmodels
from lbt_tpu.nn import layers as jlayers
from lbt_tpu.nn.core import Ctx as JCtx
from lbt_tpu.nn.model import Model as JModel
from lbt_tpu.nn.norm import BatchNorm as JBatchNorm
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch import infer
from lbt_tpu_torch.models import build_model, cifar10_resnet
from lbt_tpu_torch.nn import layers as tlayers
from lbt_tpu_torch.nn.core import Ctx, walk
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.nn.norm import BatchNorm, FusedBatchNorm, Normalization
from lbt_tpu_torch.train.trainer import Trainer

INT4W = dataclasses.replace(
    jconfig.QuantConfig.uniform(8, engine="int8", noise_mode="hash"),
    bits_w=4)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread is as fast, and leaves the CPU to
    the test suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(model: Model, seed: int = 0) -> Model:
    """Non-trivial BN running statistics, gamma and beta, and biases, so a
    fold has something to absorb (as ``tests/test_infer.py``)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in walk(model.net):
            if isinstance(layer, (Normalization, FusedBatchNorm)):
                layer.mean.normal_(0.0, 0.5, generator=gen)
                layer.var.uniform_(0.5, 2.0, generator=gen)
            if hasattr(layer, "gamma"):
                layer.gamma.uniform_(0.5, 1.5, generator=gen)
                layer.beta.normal_(0.0, 0.3, generator=gen)
            if getattr(layer, "use_bias", False):
                layer.b.normal_(0.0, 0.2, generator=gen)
    return model


def _tiny(pkg, cfg):
    """A biased conv -> BN -> Flatten -> Dense, as ``tests/test_infer.py``'s
    bias-path model, with an odd-sized kernel (3x3x3x5)."""
    L, Bn, M = ((jlayers, JBatchNorm, JModel) if pkg == "jax"
                else (tlayers, BatchNorm, Model))
    return M("tiny", [
        L.Conv2d("c1", cfg, (3, 3, 3, 5), (1, 1), "SAME", use_bias=True),
        Bn("c1-bn", cfg, 5),
        L.Flatten("flat"),
        L.Dense("fc", cfg, 8 * 8 * 5, 10),
    ], (8, 8, 3), 10, cfg)


def _case(case):
    """``(lbt_tpu model, port model)`` of a fold / export case, the port's
    initialized and randomized."""
    if case == "tiny_fused_fp32":
        cfg = dataclasses.replace(jconfig.QuantConfig.fp32(), fused_bn=True)
        jm, model = _tiny("jax", cfg), _tiny("torch", cfg)
    elif case == "tiny_int4w":
        jm, model = _tiny("jax", INT4W), _tiny("torch", INT4W)
    else:
        cfg = {"resnet8_fp32": jconfig.QuantConfig.fp32(),
               "resnet8_int8": jconfig.QuantConfig.uniform(8),
               "resnet8_fused": jconfig.QuantConfig.uniform(
                   8, fused_bn=True)}[case]
        jm = jmodels.cifar10_resnet(cfg, 8)
        model = cifar10_resnet(cfg, 8)
    return jm, randomize(model.init(torch.Generator().manual_seed(1)))


def _assert_trees(got, want, rtol=0.0, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees(got[k], want[k], rtol, f"{path}/{k}")
        return
    want = np.asarray(want)
    if want.dtype.kind in "iu" or rtol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7,
                                   err_msg=path)


_FOLD_CASES = ["resnet8_fp32", "resnet8_int8", "resnet8_fused",
               "tiny_fused_fp32", "tiny_int4w"]


@pytest.mark.parametrize("case", _FOLD_CASES)
def test_fold_batchnorm_matches_lbt_tpu(case):
    """``fold_batchnorm`` on the same parameters as lbt_tpu's: the same
    layers (every BN gone, each conv biased), folded W and b at rtol 1e-6,
    exponents (refit at the weight and bias widths) equal; the trained
    model is left intact; the folded serving forward equals lbt_tpu's at
    rtol = atol = 1e-5."""
    jm, model = _case(case)
    before = convert.to_jax_numpy(model)[:2]
    params, qstate, _ = convert.to_jax_numpy(model)
    fjm, fp, fq = jinfer.fold_batchnorm(jm, params, qstate)
    folded = infer.fold_batchnorm(model)
    assert not any(isinstance(la, BatchNorm) for la in walk(folded.net))
    p, q, _ = convert.to_jax_numpy(folded)
    _assert_trees(p, jax.tree.map(np.asarray, fp), rtol=1e-6)
    _assert_trees(q, jax.tree.map(np.asarray, fq), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(before),
                    jax.tree.leaves(convert.to_jax_numpy(model)[:2])):
        np.testing.assert_array_equal(a, b)
    assert folded.num_layers() == sum(1 for _ in _jax_walk(fjm.net))

    x = np.random.default_rng(2).normal(
        0, 1, (2, *model.input_shape)).astype(np.float32)
    want = np.asarray(fjm.apply(fp, fq, fjm.make_sinks(), jnp.asarray(x),
                                JCtx(train=False, key=None,
                                     update=False))[0])
    got = folded.apply(torch.from_numpy(x), Ctx(train=False)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_walk(layer):
    yield layer
    for c in layer.children():
        yield from _jax_walk(c)


def test_fit_exponent_matches_lbt_tpu():
    rng = np.random.default_rng(3)
    for bits in (4, 8, 16):
        for scale in (0.0, 1e-30, 1e-3, 0.9, 7.0, 127.0, 3e5):
            x = (rng.normal(0, 1, (17,)) * scale).astype(np.float32)
            assert infer._fit_exponent(torch.from_numpy(x), bits) == int(
                jinfer._fit_exponent(x, bits)), (bits, scale)


@pytest.mark.parametrize("case", ["resnet8_int8", "tiny_int4w",
                                  "tiny_int4w_folded", "mnist"])
def test_export_matches_lbt_tpu(case):
    """``export_quantized_weights``: every leaf's codes (int8, or uint8
    nibble pairs at 4 bits, an odd count padded), exponent, width and
    shape bitwise equal to lbt_tpu's; the restored weights too; and
    ``exported_nbytes`` equal."""
    if case == "mnist":
        cfg = jconfig.QuantConfig.uniform(8, stochastic=False)
        jm = jmodels.build_model("MNIST", cfg)
        model = randomize(build_model("MNIST", cfg).init(
            torch.Generator().manual_seed(4)))
    else:
        jm, model = _case(case.replace("_folded", ""))
    params, qstate, _ = convert.to_jax_numpy(model)
    if case.endswith("_folded"):
        jm, params, qstate = jinfer.fold_batchnorm(jm, params, qstate)
        model = infer.fold_batchnorm(model)
    want = jinfer.export_quantized_weights(jm, params, qstate)
    got = infer.export_quantized_weights(model)
    n_packed = [0]

    def cmp(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                cmp(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, jinfer.QuantizedLeaf):
            assert isinstance(g, infer.QuantizedLeaf), path
            assert (g.bits, g.packed) == (w.bits, w.packed), path
            assert g.exp.item() == int(w.exp), path
            assert g.shape == tuple(np.shape(params_at(path))), path
            codes = np.asarray(w.codes)
            if w.packed:
                n_packed[0] += 1
                assert g.codes.dtype == torch.uint8
                assert g.shape == w.shape
            np.testing.assert_array_equal(g.codes.numpy(),
                                          codes.astype(g.codes.numpy().dtype),
                                          err_msg=path)
            assert g.codes.numpy().dtype.itemsize == codes.dtype.itemsize
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def params_at(path):
        node = params
        for part in path.strip("/").split("/"):
            node = node[part]
        return node

    cmp(got, want, "")
    assert (n_packed[0] > 0) == ("int4w" in case)
    assert infer.exported_nbytes(got) == jinfer.exported_nbytes(want)
    _assert_trees(jax.tree.map(lambda t: t.numpy(),
                               infer.restore_quantized_weights(got)),
                  jax.tree.map(np.asarray,
                               jinfer.restore_quantized_weights(want)))


def test_pack4_round_trip_and_layout():
    """Offset binary ``code + 8``, the even index in the low nibble, an odd
    count padded with a zero nibble."""
    codes = torch.tensor([-8, 7, 0, -1, 3], dtype=torch.int8)
    packed = infer._pack4(codes)
    assert packed.tolist() == [0 | (15 << 4), 8 | (7 << 4), 11]
    assert torch.equal(infer._unpack4(packed, (5,)), codes.to(torch.int32))


def test_predictor_serves_the_trainers_checkpoint_folded(tmp_path):
    """A CPU Trainer run of a small VGG-16-shaped net under ``int4w-int8a``
    writes its checkpoint; ``Predictor.from_checkpoint`` serves it as the
    trained model does, and with ``fold_bn=True`` as ``fold_batchnorm`` of
    the trained model does (logits bitwise); the folded model's restored
    export serves with the same logits again."""
    cfg = INT4W
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (32, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, (32,)).astype(np.int32)

    def build():
        return Model("vgg_sub", [
            tlayers.Conv2d("conv1-1", cfg, (3, 3, 3, 8), (1, 1), "SAME",
                           use_bias=False),
            BatchNorm("conv1-1-bn", cfg, 8), tlayers.ReLU(),
            tlayers.MaxPool(ksize=(2, 2), strides=(2, 2), padding="VALID"),
            tlayers.Flatten(), tlayers.Dropout(keep=0.5),
            tlayers.Dense("softmax", cfg, 8 * 4 * 4, 10)],
            (8, 8, 3), 10, cfg)

    tc = tconfig.TrainConfig(batch_size=8, eval_batch_size=16, n_epoch=1,
                             log_every=100,
                             checkpoint_dir=str(tmp_path / "ckpt"))
    tr = Trainer(build(), tc, {"train": (x, y), "test": (x[:16], y[:16])},
                 logdir=str(tmp_path), device="cpu")
    tr.train()
    tr.metrics.close()
    ctx = Ctx(train=False)
    with torch.no_grad():
        want = tr.model.apply(torch.from_numpy(x[:4]), ctx)
        want_folded = infer.fold_batchnorm(tr.model).apply(
            torch.from_numpy(x[:4]), ctx)

    def logits(p):
        with torch.no_grad():
            return p.model.apply(torch.from_numpy(x[:4]), ctx)

    plain = infer.Predictor.from_checkpoint(build(), tc.checkpoint_dir,
                                            device="cpu")
    assert torch.equal(logits(plain), want)
    folded = infer.Predictor.from_checkpoint(build(), tc.checkpoint_dir,
                                             fold_bn=True, device="cpu")
    assert not any(isinstance(la, BatchNorm) for la in walk(folded.model.net))
    assert torch.equal(logits(folded), want_folded)
    assert torch.equal(folded(x[:4]), want_folded.argmax(-1))

    exported = infer.export_quantized_weights(folded.model)
    qb, fb = infer.exported_nbytes(exported)
    assert qb < 0.3 * fb
    served = infer.Predictor(infer.fold_batchnorm(build()),
                             infer.restore_quantized_weights(exported),
                             convert.to_jax_numpy(folded.model)[1],
                             device="cpu")
    assert torch.equal(logits(served), want_folded)
