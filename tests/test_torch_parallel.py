"""The port's data parallelism held against ``lbt_tpu.parallel`` on the CPU.

The JAX side runs here, on a mesh of 2 (or 4) of the 8 virtual CPU
devices (``tests/conftest.py``); the port's ranks run as processes of
``tests/torch_ranks.py`` (torch and the port only), gloo over a
``FileStore`` under ``tmp_path``, one intra-op thread each.  Inputs and
weights come from numpy seeds and the port's seeded init, carried to
``lbt_tpu`` by ``convert``.

1. the low-bit all-reduce alone, every transport, N = 2 and 4: outputs
   and residuals bitwise, the int8 wire where a partial sum reaches 128;
2. the DP train step on ResNet-8, 2 ranks of 4 rows: exponents bitwise,
   floats at rtol 1e-5, atol 1e-6, the ranks' state bitwise equal (the
   low-bit all-reduce's steps: ``test_torch_parallel_lowbit.py``);
4. the noise counter's offset against the global draw, and a rank's
   rows of the global batch and its augmentation (the masked DP eval,
   the Trainer and the CLI: ``test_torch_parallel_trainer.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import lbt_tpu.config as jconfig
from lbt_tpu.models import cifar10_resnet as jax_resnet
from lbt_tpu.nn import BatchNorm as JBatchNorm
from lbt_tpu.nn import Conv2d as JConv2d
from lbt_tpu.nn import Dense as JDense
from lbt_tpu.nn import Flatten as JFlatten
from lbt_tpu.nn import GradientBuffer as JGradientBuffer
from lbt_tpu.nn import ReLU as JReLU
from lbt_tpu.nn.model import Model as JModel
from lbt_tpu.parallel.dp import make_dp_train_step as jmake_dp_train_step
from lbt_tpu.parallel.lowbit import init_error_buffers as jinit_ebuf
from lbt_tpu.parallel.lowbit import lowbit_allreduce as jlowbit
from lbt_tpu.parallel.lowbit import ring_lowbit_allreduce as jring
from lbt_tpu.parallel.mesh import make_mesh
from lbt_tpu.train.optim import momentum_init as jmomentum_init
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.ops.kernels import quant
from torch_ranks import WD, start_ranks

pytest_plugins = ["torch_suite"]

KEY_SEED = 7
LR = 0.01
BATCH = 8          # the global batch: 2 ranks of 4 rows
N_STEPS = 3


def _mesh(n):
    return make_mesh(data=n, devices=jax.devices()[:n])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _shards(tree, n):
    """Each device's copy of a tree declared replicated (``P()``) whose
    shards differ: ``lbt_tpu``'s per-shard residuals."""
    return [jax.tree.map(lambda a, i=i: np.asarray(
        a.addressable_shards[i].data), tree) for i in range(n)]


def _assert_equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


# ---------------------------------------------------------------------------
# 1. the collective alone
# ---------------------------------------------------------------------------

LEAVES = {"a": (5, 7), "b": (33,), "c": (3, 4, 6), "wrap": (4,)}
VARIANTS = {"psum_sum": (None, "sum"), "psum_mean": (None, "mean"),
            "ring16_sum": ("int16", "sum"), "ring16_mean": ("int16", "mean"),
            "ring8_sum": ("int8", "sum"), "ring8_mean": ("int8", "mean")}


def _collective_inputs(n):
    """Per-rank gradients and buffers, leaves at different scales; leaf
    ``wrap`` holds 0.999 at element 0 on every rank, which rounds to the
    int8 wire's widest code, so its N codes sum to 128."""
    rng = np.random.default_rng(n)
    grads, bufs = [], []
    for r in range(n):
        g = {k: (rng.normal(0, 1, s) * 10.0 ** (i - 2)).astype(np.float32)
             for i, (k, s) in enumerate(LEAVES.items())}
        g["wrap"] = np.array([0.999, 0.1, -0.3, 0.2], np.float32)
        grads.append(g)
        bufs.append({k: (rng.normal(0, 1, v.shape) * 1e-3).astype(
            np.float32) for k, v in g.items()})
    return grads, bufs


def _jax_collective(grads, bufs, n, wire, reduce):
    def f(g, b):
        g, b = (jax.tree.map(lambda a: a[0], t) for t in (g, b))
        if wire is None:
            out, res = jlowbit(g, b, "data", bits=8, reduce=reduce,
                               num_shards=n)
        else:
            out, res = jring(g, b, "data", n, bits=8, wire=wire,
                             reduce=reduce)
        return (jax.tree.map(lambda a: a[None], out),
                jax.tree.map(lambda a: a[None], res))

    fn = jax.jit(jax.shard_map(f, mesh=_mesh(n),
                               in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data")),
                               check_vma=False))
    stack = [{k: np.stack([t[k] for t in ts]) for k in ts[0]}
             for ts in (grads, bufs)]
    out, res = fn(*stack)
    return [({k: np.asarray(v[r]) for k, v in out.items()},
             {k: np.asarray(v[r]) for k, v in res.items()})
            for r in range(n)]


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    runs = {}
    for n in (2, 4):
        grads, bufs = _collective_inputs(n)
        runs[n] = (grads, bufs, start_ranks(
            tmp_path_factory.mktemp(f"coll{n}"),
            {"coll": {"kind": "collectives", "grads": grads, "bufs": bufs,
                      "variants": VARIANTS}}, n))
    return {n: (g, b, wait()) for n, (g, b, wait) in runs.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n", [2, 4])
def test_lowbit_collective_matches_lbt_tpu(collectives, n, variant):
    """Each transport's reduced gradients and each rank's residuals equal
    ``lbt_tpu``'s under ``shard_map``, bit for bit; the int16 ring equals
    the psum transport."""
    grads, bufs, port = collectives[n]
    wire, reduce = VARIANTS[variant]
    want = _jax_collective(grads, bufs, n, wire, reduce)
    for r in range(n):
        got_out, got_res = port[r]["coll"][variant]
        _assert_equal_trees(got_out, want[r][0], f"rank {r} out")
        _assert_equal_trees(got_res, want[r][1], f"rank {r} residual")
    if wire == "int16":
        for r in range(n):
            for got, psum in zip(port[r]["coll"][variant],
                                 port[r]["coll"]["psum_" + reduce]):
                _assert_equal_trees(got, psum)


@pytest.mark.parametrize("n", [2, 4])
def test_int8_wire_wraps_as_lbt_tpu(collectives, n):
    """Where every rank's code is the int8 wire's widest (2**(7 -
    ceil(log2 N))), their sum is 128: it wraps to -128 in int8, in
    ``lbt_tpu``'s ring and in the port's (ROADMAP queue 3)."""
    _, _, port = collectives[n]
    out = port[0]["coll"]["ring8_sum"][0]["wrap"][0]
    # every rank's total is 0.999 + its buffer; the exponent is 0, the
    # multiplier 2**(7 - 0 - ceil(log2 N))
    assert out == -128.0 / 2 ** (7 - int(np.ceil(np.log2(n))))
    assert port[0]["coll"]["psum_sum"][0]["wrap"][0] > 0.9 * n


# ---------------------------------------------------------------------------
# 2-3. the DP train step
# ---------------------------------------------------------------------------

STEP_CASES = {
    # (a) the reference-faithful options
    "hash": dict(model={"kind": "resnet8", "cfg": {"noise_mode": "hash"}}),
    # (b) the headline's options at f32 carriers; cadence 2 without
    # warmup: gate on, off, on
    "headline": dict(model={"kind": "resnet8", "cfg": {
        "engine": "int8", "noise_mode": "hash1", "fused_bn": True,
        "range_update_every": 2, "range_update_warmup_steps": 0,
        "conv_act_extra": 0}}),
    # the FP32 arm: BN's float moments, synced with a backward of their own
    "bnnet_fp32": dict(model={"kind": "bnnet", "bits": 32, "cfg": {}}),
    # a GradientBuffer's residual, averaged over the ranks
    "gradbuf": dict(model={"kind": "gbnet", "cfg": {"noise_mode": "hash"}}),
}


def _step_data(kind, seed=0):
    rng = np.random.default_rng(seed)
    shape, classes = {"resnet8": ((BATCH, 32, 32, 3), 10),
                      "bnnet": ((BATCH, 8, 8, 3), 4),
                      "toy": ((BATCH, 20), 4), "gbnet": ((BATCH, 20), 4)}[kind]
    return [(rng.normal(0, 1, shape).astype(np.float32),
             rng.integers(0, classes, (BATCH,)).astype(np.int32))
            for _ in range(N_STEPS)]


def _jax_model(spec):
    cfg = jconfig.QuantConfig.uniform(spec.get("bits", 8), **spec["cfg"])
    if spec["kind"] == "resnet8":
        return jax_resnet(cfg, 8, weight_decay=WD)
    if spec["kind"] == "bnnet":
        return JModel("bnnet", [
            JConv2d("c1", cfg, (3, 3, 3, 8), use_bias=False),
            JBatchNorm("bn", cfg, 8), JReLU(), JFlatten(),
            JDense("d", cfg, 512, 4)],
            input_shape=(8, 8, 3), num_classes=4, cfg=cfg)
    mid = ([JGradientBuffer("gb", cfg, (4, 64))]
           if spec["kind"] == "gbnet" else [])
    return JModel(spec["kind"], [JDense("d1", cfg, 20, 64), *mid, JReLU(),
                                 JDense("d2", cfg, 64, 4)],
                  input_shape=(20,), num_classes=4, cfg=cfg)


def jax_steps(spec, init):
    """``lbt_tpu``'s DP step of ``spec`` from the port's initial state,
    after each step: (loss, accuracy, params, qstate, velocity, each
    shard's ebuf)."""
    jm = _jax_model(spec["model"])
    step = jmake_dp_train_step(jm, jconfig.TrainConfig(), _mesh(2),
                               lowbit_bits=spec.get("lowbit_bits"),
                               lowbit_wire=spec.get("lowbit_wire"),
                               donate=False)
    params, qstate, _ = init
    params = jax.tree.map(jnp.asarray, params)
    qstate = jax.tree.map(jnp.asarray, qstate)
    vel, ebuf = jmomentum_init(params), jinit_ebuf(params)
    out = []
    for s, (x, y) in enumerate(_step_data(spec["model"]["kind"])):
        params, qstate, vel, ebuf, m = step(
            params, qstate, vel, ebuf, x, y, s, jnp.float32(LR),
            jax.random.key(KEY_SEED))
        out.append((float(m["loss"]), float(m["accuracy"]), _np(params),
                    _np(qstate), _np(vel), _shards(ebuf, 2)))
    return out


def run_dp_cases(tmp, cases: dict):
    """Every case of ``cases`` on 2 ranks, in one launch."""
    jobs = {case: {"kind": "dp_steps", "batch": BATCH, "lr": LR,
                   "key": keys.base_key(KEY_SEED),
                   "data": _step_data(spec["model"]["kind"]), **spec}
            for case, spec in cases.items()}
    return start_ranks(tmp, jobs, 2)()


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    return run_dp_cases(tmp_path_factory.mktemp("dp"), STEP_CASES)


def close_trees(got, want, path=""):
    """Integer leaves (exponents) bitwise, float leaves at rtol 1e-5,
    atol 1e-6."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            close_trees(got[k], want[k], f"{path}/{k}")
    elif want.dtype == np.int32:
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=path)


def check_dp_steps(spec, port, want):
    """The port's ranks (``port``, each rank's results) against
    ``lbt_tpu``'s (``want``, :func:`jax_steps`) after every step: losses
    at rtol 1e-5, accuracies bitwise, state by :func:`close_trees`; with
    the low-bit all-reduce each rank's ``ebuf`` against ``lbt_tpu``'s
    shard the same way."""
    for s, (loss, acc, p, q, v, eb) in enumerate(want):
        got = port[0]["steps"][s]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert got["acc"] == acc
        close_trees(got["qstate"], q, f"step {s} qstate")
        close_trees(got["params"], p, f"step {s} params")
        close_trees(got["velocity"], v, f"step {s} velocity")
        if "lowbit_bits" in spec:
            for r in range(2):
                close_trees(port[r]["steps"][s]["ebuf"], eb[r],
                            f"step {s} rank {r} ebuf")


def check_equal_ranks(port):
    """After every step both ranks hold the same parameters, velocity,
    exponents and BN statistics, bit for bit; only ``ebuf`` is each
    rank's own."""
    for s in range(N_STEPS):
        a, b = (r["steps"][s] for r in port)
        for k in ("params", "qstate", "velocity"):
            _assert_equal_trees(a[k], b[k], f"step {s} {k}")
        assert (a["loss"], a["acc"]) == (b["loss"], b["acc"])


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_dp_step_matches_lbt_tpu(dp_runs, case):
    """3 steps of the port's DP step on 2 ranks of 4 rows against
    ``lbt_tpu``'s ``make_dp_train_step`` on a 2-device mesh: (a) ResNet-8
    under ``uniform(8, noise_mode='hash')``, (b) under the headline's
    options at f32 carriers, controllers on, off, on; the FP32 arm of a
    conv + BN net (BN's float moments); and a GradientBuffer between two
    Dense layers (its residual averaged over the ranks).  Losses at rtol
    1e-5, accuracies and every exponent bitwise at every step;
    parameters, velocity and BN state at rtol 1e-5, atol 1e-6.  (The
    port's BN moments are exact code sums, ``lbt_tpu``'s f32 means; at 4
    rows a rank they agree here, and the single-device comparison's
    one-LSB allowance is not needed.)"""
    port = [r[case] for r in dp_runs]
    check_dp_steps(STEP_CASES[case], port,
                   jax_steps(STEP_CASES[case], port[0]["init"]))


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_dp_ranks_hold_equal_state(dp_runs, case):
    """Both ranks' replicated state is bitwise equal after every step."""
    check_equal_ranks([r[case] for r in dp_runs])


def _exps(tree, path=""):
    """The int32 leaves (exponents) of a qstate tree, by path."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _exps(tree[key], f"{path}/{key}").items()}
    return {path: int(tree)} if tree.dtype == np.int32 else {}


def test_dp_gated_off_step_averages_no_statistics(dp_runs):
    """The headline case's cadence (controllers on, off, on): the
    gated-off step runs no statistics collective, and its exponents are
    those it started from, as the one-device step's hold leaves them
    (they lie in range); the cadence-1 case averages statistics on every
    step."""
    for r in dp_runs:
        head, hash_ = r["headline"], r["hash"]
        calls = [s["stats_calls"] for s in head["steps"]]
        assert 0 < calls[0] == calls[1] < calls[2]
        assert _exps(head["steps"][1]["qstate"]) == _exps(
            head["steps"][0]["qstate"])
        calls = [s["stats_calls"] for s in hash_["steps"]]
        assert 0 < calls[0] < calls[1] < calls[2]


# ---------------------------------------------------------------------------
# 4. the masked DP eval and the noise counter's offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("mode", [quant.HASH, quant.HASH1, quant.THREEFRY])
def test_offset_draws_the_global_batch_rows(mode, shared):
    """Rows ``row0..`` of a batch drawn with ``offset = row0 *
    prod(shape[1:])`` equal those rows of the whole batch's draw, in every
    stream, shared along axis 0 or not (``dfxp.quantize.noise_spec``)."""
    from lbt_tpu_torch.dfxp.quantize import noise_spec
    backend = {quant.HASH: "xla_hash", quant.HASH1: "xla_hash1",
               quant.THREEFRY: "xla"}[mode]
    key = keys.fold_in(keys.base_key(3), 5)
    shape = (8, 3, 5, 4)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, shape).astype(np.float32))
    whole = quant.quantize_codes(x, 8, 2, noise_spec(key, True, backend,
                                                     shape, shared))[0]
    for row0, rows in ((0, 4), (4, 4), (2, 3)):
        part = x[row0:row0 + rows].contiguous()
        noise = noise_spec(key, True, backend, part.shape, shared, row0)
        assert noise.offset == (0 if shared else row0 * 60)
        assert torch.equal(quant.quantize_codes(part, 8, 2, noise)[0],
                           whole[row0:row0 + rows])
    u = quant.noise_uniform(noise_spec(key, True, backend, shape, shared),
                            x.numel())
    v = quant.noise_uniform(noise_spec(key, True, backend, (3,) + shape[1:],
                                       shared, 5), 180)
    assert torch.equal(u[300:], v)




def test_rank_rows_take_the_global_batch_draws():
    """A rank's rows of a global batch, augmented with ``rows=(row0,
    n_global)``, equal those rows of the global batch augmented whole;
    ``batch_iterator(rows=...)`` gathers exactly those rows."""
    from lbt_tpu_torch.data.datasets import augment_crop_flip
    from lbt_tpu_torch.data.pipeline import batch_iterator
    key = keys.fold_in(keys.base_key(1), 3)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (8, 32, 32, 3)).astype(np.float32))
    whole = augment_crop_flip(key, x, 4)
    for row0 in (0, 4):
        part = augment_crop_flip(key, x[row0:row0 + 4], 4, rows=(row0, 8))
        assert torch.equal(part, whole[row0:row0 + 4])
    xs = np.arange(40, dtype=np.float32)[:, None]
    ys = np.arange(40, dtype=np.int32)
    full = list(batch_iterator(xs, ys, 8, seed=3, epoch=1))
    mine = list(batch_iterator(xs, ys, 8, seed=3, epoch=1, rows=(2, 3)))
    assert len(full) == len(mine) == 5
    for (fx, fy), (mx, my) in zip(full, mine):
        np.testing.assert_array_equal(mx, fx[2:5])
        np.testing.assert_array_equal(my, fy[2:5])


@pytest.mark.parametrize("split", ["train", "eval"])
def test_imagefolder_decodes_only_the_rank_rows(tmp_path, split,
                                                 monkeypatch):
    """A rank's ``rows=(start, size)`` of a streaming ImageFolder source
    are those rows of the global batches, and only they are decoded (a
    ragged last eval batch leaves the last rank fewer rows, or none)."""
    import os
    from lbt_tpu_torch.data import imagefolder
    from test_torch_records import _write_tree
    root = _write_tree(str(tmp_path))
    data = imagefolder.streaming_dataset(
        os.path.join(root, "train"), os.path.join(root, "val"),
        image_size=32, seed=5, workers=2)
    if split == "train":
        def batches(**kw):
            return list(data["train_iter"](1, 4, **kw))
    else:
        def batches(**kw):
            return list(data["test_iter"](4, **kw))
    whole = batches()
    loads = []
    real = imagefolder.ImageFolderDataset._load
    monkeypatch.setattr(imagefolder.ImageFolderDataset, "_load",
                        lambda self, i, e: loads.append(i) or real(self, i, e))
    for start in (0, 2):
        loads.clear()
        mine = batches(rows=(start, 2))
        assert len(mine) == len(whole)
        for (x, y), (xw, yw) in zip(mine, whole):
            np.testing.assert_array_equal(x, xw[start:start + 2])
            np.testing.assert_array_equal(y, yw[start:start + 2])
        assert len(loads) == sum(len(y) for _, y in mine)
