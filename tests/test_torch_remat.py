"""``remat_bn``, ``bn_residual_q16`` and ``scan_steps`` held against
lbt_tpu on the CPU.

The BN flags: ``Normalization`` + ``Rescale``, ``FusedBatchNorm`` and the
conv -> BN route through ``forward_from`` (the plain version of #4 / #5),
under f32 and bf16 carriers, against ``lbt_tpu``'s eager ``apply`` with
the same flags (its ``jax.checkpoint`` around each BN layer, its
``_tag_xq``): codes and sinks bitwise, the rest at the tolerances of
``test_torch_fused_bn.py``.  Within the port, ``remat_bn`` changes no bit;
``bn_residual_q16`` rounds the cotangent into the BN's quantized input to
bf16 where the carrier is f32, and changes no bit under bf16 carriers.
Under either flag no BN layer saves an f32 tensor of activation size for
the backward.  Three ResNet-8 steps under each flag against lbt_tpu's
jitted step (without excess precision: allowed it, XLA on the CPU may drop
the bf16 round trip that q16's rounding is made of).

``scan_steps``: ``make_scan_train_step`` against eager steps, and the
scanned Trainer against lbt_tpu's scanned Trainer.
"""

import jax
import numpy as np
import pytest
import torch

import lbt_tpu.config as jconfig
from lbt_tpu.data import datasets as jdatasets
from lbt_tpu.nn import Sequential as JSequential
from lbt_tpu.nn.core import finalize as jfinalize
from lbt_tpu.nn.layers import Conv2d as JConv2d
from lbt_tpu.nn.norm import BatchNorm as JBatchNorm
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.data.datasets import make_augment
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.nn import norm as norm_module
from lbt_tpu_torch.nn.core import Sequential, finalize
from lbt_tpu_torch.nn.layers import Conv2d
from lbt_tpu_torch.nn.norm import BatchNorm
from lbt_tpu_torch.train.optim import momentum_init
from lbt_tpu_torch.train.step import make_scan_train_step, make_train_step

from test_torch_fused_bn import record_codes  # noqa: F401 (a fixture)
from test_torch_fused_bn import (TOL, _compare_state, _randomize,
                                 compare_train, run_both, run_port)
from test_torch_imagenet import headline
from test_torch_train import compare_train_steps, resnet_pair
from test_torch_trainer import _compare_trees, _lsb, _numpy, _pair, _rows

FLAGS = {"off": {}, "remat": {"remat_bn": True},
         "q16": {"bn_residual_q16": True},
         "both": {"remat_bn": True, "bn_residual_q16": True}}


def _cifar(module, carrier, **kw):
    """The CIFAR configurations' QuantConfig (f32 carriers there, unfused
    BN, 9-bit conv activations) at ``carrier``."""
    return module.QuantConfig.uniform(8, noise_mode="hash",
                                      act_dtype=carrier, **kw)


def _fused(module, carrier, **kw):
    return headline(carrier, module, **kw)


# form -> (its QuantConfig of a module and carrier, conv ahead of the BN)
FORMS = {"unfused": (_cifar, False), "fused": (_fused, False),
         "conv_unfused": (_cifar, True), "conv_fused": (_fused, True)}
X_SHAPE, C = (2, 6, 5, 16), 24


def _layers(mods, cfg, conv):
    conv_cls, bn_cls = mods
    if not conv:
        return bn_cls("bn", cfg, C)
    return [conv_cls("conv", cfg, (3, 3, X_SHAPE[-1], C), (1, 1), "SAME",
                     use_bias=False), bn_cls("bn", cfg, C)]


def _build(form, flag, carrier):
    make, conv = FORMS[form]
    jcfg = make(jconfig, carrier, **FLAGS[flag])
    tcfg = make(tconfig, carrier, **FLAGS[flag])
    if conv:
        return (jfinalize(JSequential("net", _layers((JConv2d, JBatchNorm),
                                                     jcfg, True))),
                finalize(Sequential("net", _layers((Conv2d, BatchNorm), tcfg,
                                                   True))))
    return (jfinalize(_layers((JConv2d, JBatchNorm), jcfg, False)),
            finalize(_layers((Conv2d, BatchNorm), tcfg, False)))


def _inputs(conv):
    rng = np.random.default_rng(11)
    shape = X_SHAPE if conv else X_SHAPE[:3] + (C,)
    x = rng.normal(0, 1, shape).astype(np.float32)
    g = (rng.normal(0, 1, X_SHAPE[:3] + (C,)) * 2.0 ** -6).astype(np.float32)
    return x, g


def _bf16_exact(a) -> bool:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return torch.equal(t, t.to(torch.bfloat16).to(torch.float32))


def _equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("carrier", ["f32", "bf16"])
@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_bn_flags_match_lbt_tpu(form, flag, carrier, record_codes):
    """One training call of the BN form under the flag against lbt_tpu's
    eager ``apply`` with the same flag: output, new exponents and BN
    state at TOL, gradients at TOL, sinks bitwise; the BN input's codes
    bitwise against the port's with the flags off.  Within the port,
    ``remat_bn`` changes no bit, nor does ``bn_residual_q16`` under bf16
    carriers; under f32 carriers q16 leaves the forward as it was and
    makes the BN input's gradient bf16-exact, equal to lbt_tpu's."""
    jlayer, layer = _build(form, flag, carrier)
    conv = FORMS[form][1]
    x, g = _inputs(conv)
    want, got, params = run_both(jlayer, layer, x, "train", carrier, g,
                                 jit=False)
    np.testing.assert_allclose(got["y"], want["y"], **TOL)
    _compare_state(got["q"], want["q"])
    compare_train(want, got, layer)
    codes = [c.clone() for c in record_codes]

    # the port with the flags off, from the same trees and input
    off = _build(form, "off", carrier)[1]
    record_codes.clear()
    qstate = _randomize(*jlayer.init(jax.random.key(0)), seed=3)[1]
    base = run_port(off, params, qstate, x, "train", carrier, g)
    assert len(codes) == len(record_codes) == (
        2 if "unfused" in form else 1)
    for a, b in zip(codes, record_codes):
        assert torch.equal(a, b)
    q16 = FLAGS[flag].get("bn_residual_q16", False)
    if not q16 or carrier == "bf16":
        _equal(got, base)
        return
    for k in ("y", "q", "p"):
        _equal(got[k], base[k], k)
    if not conv:
        assert _bf16_exact(got["dx"]) and _bf16_exact(want["dx"])
        assert not _bf16_exact(base["dx"])
        np.testing.assert_array_equal(got["dx"], want["dx"])


# ---------------------------------------------------------------------------
# what the backward keeps
# ---------------------------------------------------------------------------

BN_FORWARDS = (("Normalization", "forward"),
               ("Normalization", "forward_from_conv"),
               ("Rescale", "forward"), ("FusedBatchNorm", "forward"),
               ("FusedBatchNorm", "forward_from_conv"))


def _saved_by_bn(monkeypatch, cfg):
    """One ResNet-8 train step under ``cfg`` at batch 4; for each BN
    layer call, the shapes of the f32 tensors of activation size (more
    elements than the layer has channels) it saved for the backward."""
    saved = []

    def wrap(fn):
        def forward(self, *args):
            big = []

            def pack(t):
                if (t.dtype == torch.float32
                        and t.numel() > self.num_features):
                    big.append(tuple(t.shape))
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                y = fn(self, *args)
            saved.append((type(self).__name__, big))
            return y
        return forward

    for cls, name in BN_FORWARDS:
        klass = getattr(norm_module, cls)
        monkeypatch.setattr(klass, name, wrap(getattr(klass, name)))
    model = cifar10_resnet(cfg, 8).init(torch.Generator().manual_seed(0))
    step = make_train_step(model, tconfig.TrainConfig())
    rng = np.random.default_rng(0)
    step(model, momentum_init(dict(model.net.named_parameters())),
         torch.from_numpy(rng.normal(0, 1, (4, 32, 32, 3)).astype(
             np.float32)), torch.tensor([1, 2, 3, 4]), 0, 0.01,
         keys.base_key(7))
    n_bn = sum(isinstance(m, (norm_module.Normalization, norm_module.Rescale,
                              norm_module.FusedBatchNorm))
               for m in model.net.modules())
    assert len(saved) == n_bn
    return saved


@pytest.mark.parametrize("fused_bn", [False, True])
@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_bn_saves_no_f32_activation_under_the_flags(monkeypatch, flag,
                                                    fused_bn):
    """Under either flag no BN layer of a ResNet-8 train step saves an f32
    tensor of its input's size (codes, multipliers and per-channel
    tensors only).  With the flags off the unfused BN saves its f32
    ``xq`` and ``xq - mean`` (Normalization) and ``xq`` (Rescale), as
    before; the fused BN saves codes either way."""
    cfg = tconfig.QuantConfig.uniform(8, noise_mode="hash",
                                      fused_bn=fused_bn, **FLAGS[flag])
    saved = _saved_by_bn(monkeypatch, cfg)
    names = {n for n, _ in saved}
    assert names == ({"FusedBatchNorm"} if fused_bn
                     else {"Normalization", "Rescale"})
    if flag != "off" or fused_bn:
        assert all(not big for _, big in saved), saved
    else:
        assert all(len(big) == (2 if n == "Normalization" else 1)
                   for n, big in saved), saved


@pytest.mark.parametrize("flag", ["remat", "q16", "both"])
def test_train_steps_under_bn_flags_match_lbt_tpu(flag):
    """Three ResNet-8 steps under uniform(8, noise_mode='hash') with the
    flag, against lbt_tpu's jitted ``make_train_step`` with it (jitted
    without excess precision), at the tolerances of
    ``compare_train_steps``."""
    compare_train_steps(*resnet_pair(jconfig.QuantConfig.uniform(
        8, noise_mode="hash", **FLAGS[flag])))


# ---------------------------------------------------------------------------
# scan_steps
# ---------------------------------------------------------------------------


def _resnet8(seed=0):
    cfg = tconfig.QuantConfig.uniform(8, noise_mode="hash")
    return cifar10_resnet(cfg, 8).init(torch.Generator().manual_seed(seed))


def test_scan_step_matches_eager_steps():
    """``make_scan_train_step`` with K = 3 and the augmentation equals 3
    eager steps, each augmented with ``fold_in(aug_key, step)``, bit for
    bit, in every state tensor and metric (``lbt_tpu``'s
    ``tests/test_train.py:test_scan_step_matches_sequential``)."""
    tc = tconfig.TrainConfig()
    augment = make_augment("cifar10")
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.normal(0, 1, (3, 4, 32, 32, 3)).astype(
        np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, (3, 4)))
    base, aug_key = keys.base_key(5), keys.base_key(6)
    runs = []
    for scanned in (False, True):
        model = _resnet8()
        vel = momentum_init(dict(model.net.named_parameters()))
        if scanned:
            ms = make_scan_train_step(model, tc, 3, augment=augment)(
                model, vel, xs, ys, 2, 0.02, base, aug_key)
        else:
            step = make_train_step(model, tc)
            out = [step(model, vel, augment(keys.fold_in(aug_key, 2 + i),
                                            xs[i]), ys[i], 2 + i, 0.02, base)
                   for i in range(3)]
            ms = {k: torch.stack([m[k] for m in out]) for k in out[0]}
        runs.append((ms, model.net.state_dict(), vel))
    (m0, s0, v0), (m1, s1, v1) = runs
    assert m1["loss"].shape == (3,)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k in v0:
        assert torch.equal(v0[k], v1[k]), k
    with pytest.raises(ValueError, match="expected 3"):
        make_scan_train_step(model, tc, 3)(model, v1, xs[:2], ys[:2], 0,
                                           0.02, base)


def test_scanned_trainer_matches_lbt_tpus(tmp_path):
    """6 steps (batch 4, one block of 4 and 2 steps one by one) of the
    port's Trainer with ``scan_steps=4`` against ``lbt_tpu``'s scanned
    Trainer from the same weights and key, without augmentation (the
    port's draws are not ``jax.random``'s): exponents bitwise, the rest at
    the tolerances of ``test_trainer_trajectory_matches_lbt_tpu``; the
    rows of ``metrics.jsonl`` at the same steps (a row a block, once
    ``log_every`` steps have passed), with the same losses at rtol
    1e-5."""
    data = jdatasets.load_dataset("cifar10", n_train=24, n_test=8)
    kw = dict(batch_size=4, n_epoch=1, seed=7, log_every=2, scan_steps=4,
              weight_decay=2e-4)
    jtr, ttr, params, qstate = _pair(
        (jconfig.QuantConfig.uniform(8, noise_mode="hash"),
         tconfig.QuantConfig.uniform(8, noise_mode="hash")),
        (jconfig.TrainConfig(**kw), tconfig.TrainConfig(**kw)), data)
    assert jtr.scan_train_step is not None
    assert ttr.scan_train_step is not None
    from lbt_tpu.utils.logging import MetricsWriter as JMetricsWriter
    from lbt_tpu_torch.utils.logging import MetricsWriter
    jtr.metrics = JMetricsWriter(str(tmp_path / "jax"))
    ttr.metrics = MetricsWriter(str(tmp_path / "port"))
    jtr.train_epoch(0)
    ttr.train_epoch(0)
    jtr.metrics.close()
    ttr.metrics.close()
    assert ttr.step == jtr.step == 6
    p, q, v = convert.to_jax_numpy(ttr.model, ttr.velocity)
    jq_np = _numpy(jtr.qstate)

    def lsb_of(path):
        node = jq_np
        parts = path.strip("/").split("/")
        for part in parts[:-1]:
            node = node[part]
        exps = node.get("exp", {}) if isinstance(node, dict) else {}
        site = {"W": "w", "gamma": "gamma", "beta": "beta"}.get(parts[-1],
                                                                "x")
        return _lsb(8, exps.get(site, 2))

    _compare_trees(q, jq_np, lambda path: _lsb(8, 2))
    _compare_trees(p, _numpy(jtr.params), lsb_of)
    _compare_trees(v, _numpy(jtr.velocity), lsb_of)
    rows = {w: [r for r in _rows(tmp_path / w / "metrics.jsonl")
                if "train/loss" in r] for w in ("jax", "port")}
    assert [r["step"] for r in rows["port"]] == [
        r["step"] for r in rows["jax"]] == [4, 6]
    for a, b in zip(rows["port"], rows["jax"]):
        np.testing.assert_allclose(a["train/loss"], b["train/loss"],
                                   rtol=1e-5)
        assert a["train/accuracy"] == b["train/accuracy"]
    assert not any("train/input_stall_frac" in r
                   for r in _rows(tmp_path / "port" / "metrics.jsonl"))
