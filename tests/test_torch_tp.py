"""The port's tensor parallelism on the CPU, held against its own one-rank
step (torch only; ``test_torch_tp_jax.py`` holds it against ``lbt_tpu``'s
GSPMD step, ``test_torch_tp_trainer.py`` the Trainer and the CLI):

1. the noise's column window: the plain K1 and ``conv_fused_plain`` of a
   column slice, given ``(n_global, col0)``, equal the same slice of the
   whole tensor's result, bitwise, in every noise mode, shared or not,
   at a row offset, for tp 2 and 4;
2. ``initialize`` under ``lbt_tpu``'s variables (one process a host) and
   under torchrun's: the backend and the card of each rank;
3. the layout: 3 train steps under ``uniform(8, noise_mode="hash")``
   with the controllers on, at tp = 2 (1 x 2: the one-rank step on the
   sharded model, as ``lbt_tpu``'s GSPMD step is its one-device step)
   against the one-rank step, and at dp x tp = 2 x 2 (the data-parallel
   step) against dp 2 on the same rows: parameters,
   velocity, exponents, BN state and loss equal at tolerance 0, on the
   Dense toy and on ResNet-8 (batch 4), and a 256 x 130 layer at tp = 4;
   on the float route (``sim_bf16`` on the toy and ResNet-8, the
   toy's 9-bit dense operands on ``int8``, ``sim`` at a 1% overflow
   target, ResNet-8 on ``int8`` with 16-bit cotangents), the same
   comparisons at f32
   tolerance, with one partial-dx sum a sharded layer a step;
4. tp x the low-bit all-reduce: 2 x 2 with ``lowbit_allreduce``, psum
   and int8 ring, equal to dp 2 bitwise;
5. ``param_pspecs`` and ``shard_params`` / ``gather_params``.

The ranks are processes of ``tests/torch_ranks.py`` (gloo over a
``FileStore``, one thread each), one launch of 4 for every layout.
"""

import itertools
from unittest import mock

import numpy as np
import pytest
import torch

from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.dfxp.quantize import noise_spec, quantize_int
from lbt_tpu_torch.ops.im2col import conv_pads
from lbt_tpu_torch.ops.kernels import quant
from lbt_tpu_torch.ops.kernels.conv_fused import (conv1x1_fused,
                                                  conv3x3_fused)
from lbt_tpu_torch.parallel import mesh, multihost
from torch_ranks import build, start_ranks

pytest_plugins = ["torch_suite"]

KEY = (7, 11)
MODES = {"hash": "xla_hash", "hash1": "xla_hash1", "threefry": "xla",
         "nearest": None}


# ---------------------------------------------------------------------------
# 1. the column window
# ---------------------------------------------------------------------------

def _slices(n, tp):
    return [mesh.column_slice(n, tp, m) for m in range(tp)]


@pytest.mark.parametrize("row0", [0, 3])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_k1_column_window_equals_slice_of_whole(mode, tp, shared, row0):
    """K1's plain version on a column slice with its window gives the
    whole tensor's codes (and the slice's min / max) at those columns,
    the width uneven over 4."""
    x = torch.from_numpy(np.random.default_rng(tp).normal(
        0, 2, (6, 5, 42)).astype(np.float32))
    kw = dict(stochastic=MODES[mode] is not None,
              backend=MODES[mode] or "xla_hash",
              noise_shared_axis0=shared, row0=row0)
    whole = quantize_int(x, 8, 2, KEY, **kw)[0]
    for col0, width in _slices(42, tp):
        part = x[..., col0:col0 + width].contiguous()
        codes, _, mm = quantize_int(part, 8, 2, KEY, stats=True,
                                    window=(col0, 42), **kw)
        assert torch.equal(codes, whole[..., col0:col0 + width])
        scaled = part * quant.multiplier(8, 2)
        assert torch.equal(mm, torch.stack([scaled.amin(), scaled.amax()]))


@pytest.mark.parametrize("row0", [0, 3])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_conv_fused_column_window_equals_slice_of_whole(mode, tp, shared,
                                                        row0):
    """#4 and #5's plain version on a weight's column slice, the noise
    window at its columns of the BN input, gives the whole conv's codes
    and moments at those channels (Cout 18, uneven over 4); the min /
    max are the slice's."""
    gen = torch.Generator().manual_seed(tp)
    xc = torch.randint(-120, 120, (2, 6, 6, 16), dtype=torch.int8,
                       generator=gen)
    inv, mult = torch.tensor([2.0 ** -12]), torch.tensor([8.0])
    for fn, k in ((conv3x3_fused, 3), (conv1x1_fused, 1)):
        wc = torch.randint(-120, 120, (k, k, 16, 18), dtype=torch.int8,
                           generator=gen)
        pads = conv_pads("SAME", (6, 6), (k, k), (1, 1))
        key = KEY if MODES[mode] else None
        noise = noise_spec(key, key is not None, MODES[mode] or "xla",
                           (2, 6, 6, 18), shared, row0)
        codes, moments, _ = fn(xc, wc, inv, mult, strides=(1, 1), pads=pads,
                               noise=noise)
        for col0, width in _slices(18, tp):
            part = wc[..., col0:col0 + width].contiguous()
            noise = noise_spec(key, key is not None, MODES[mode] or "xla",
                               (2, 6, 6, width), shared, row0, (col0, 18))
            c, mo, mm = fn(xc, part, inv, mult, strides=(1, 1), pads=pads,
                           noise=noise)
            assert torch.equal(c, codes[..., col0:col0 + width])
            assert torch.equal(mo, moments[:, col0:col0 + width])
            y = (torch.nn.functional.conv2d(
                xc.permute(0, 3, 1, 2).double(),
                part.permute(3, 2, 0, 1).double(),
                padding=k // 2).float() * inv)
            assert torch.equal(mm, torch.stack([y.amin(), y.amax()]))


def test_window_is_the_identity_on_a_whole_tensor():
    """A window over the whole width draws as no window: the noise
    descriptor has none, and every path that does not shard is as
    before."""
    assert noise_spec(KEY, True, "xla_hash", (4, 10), False, 0,
                      (0, 10)) == noise_spec(KEY, True, "xla_hash", (4, 10))
    n = noise_spec(KEY, True, "xla", (4, 5), True, 0, (5, 10))
    assert (n.n_global, n.col0, n.inner) == (10, 5, 10)


def test_window_counters_are_checked():
    """A window that does not fit the tensor, or whose last counter
    passes 2**32, is refused before any launch."""
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="does not fit"):
        quant.quantize_codes(x, 8, 0, quant.Noise(1, 3, n_global=8,
                                                   col0=4))
    big = quant.Noise(1, 3, n_global=2 ** 31, col0=0)
    with pytest.raises(ValueError, match="bad noise"):
        quant.quantize_codes(x, 8, 0, big)
    assert quant.noise_end(quant.Noise(1, 3, offset=5, n_global=20,
                                       col0=10), x) == 3 * 20 + 10 + 6 + 5


# ---------------------------------------------------------------------------
# 2. initialize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,cards,backend,card", [
    # lbt_tpu's variables: one process a host, card 0, NCCL
    ({"NUM_PROCESSES": "16", "PROCESS_ID": "5",
      "COORDINATOR_ADDRESS": "h0:1234"}, 8, "nccl", 0),
    ({"NUM_PROCESSES": "2", "PROCESS_ID": "1",
      "COORDINATOR_ADDRESS": "h0:1234"}, 1, "nccl", 0),
    # with torchrun's local variables beside them, those rule
    ({"NUM_PROCESSES": "16", "PROCESS_ID": "5", "LOCAL_RANK": "5",
      "LOCAL_WORLD_SIZE": "8", "COORDINATOR_ADDRESS": "h0:1234"}, 8,
     "nccl", 5),
    # torchrun: ranks of one host, a card each, or sharing the cards
    ({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "3",
      "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "h0", "MASTER_PORT": "9"},
     8, "nccl", 3),
    ({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "3",
      "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "h0", "MASTER_PORT": "9"},
     1, "gloo", 0),
])
def test_initialize_backend_and_card(monkeypatch, env, cards, backend,
                                     card):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "NUM_PROCESSES", "PROCESS_ID",
              "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    with mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(torch.cuda, "device_count", lambda: cards), \
            mock.patch.object(torch.cuda, "set_device",
                              lambda d: seen.setdefault("set", d)), \
            mock.patch.object(multihost.dist, "init_process_group",
                              lambda b, **kw: seen.update(b=b, **kw)), \
            mock.patch.object(multihost, "Group",
                              lambda device: device):
        dev = multihost.initialize("cuda")
    assert seen["b"] == backend
    assert dev == torch.device("cuda", card) == seen["set"]
    world = env.get("WORLD_SIZE", env.get("NUM_PROCESSES"))
    assert (seen["world_size"], seen["rank"]) == (
        int(world), int(env.get("RANK", env.get("PROCESS_ID"))))
    assert seen["init_method"] == (
        "tcp://h0:9" if "MASTER_ADDR" in env else "tcp://h0:1234")


# ---------------------------------------------------------------------------
# 3-4. the layout against the one-rank and data-parallel steps
# ---------------------------------------------------------------------------

N_STEPS = 3
LR = 0.05
HASH = {"noise_mode": "hash"}


def _batches(model_kind, batch, seed):
    model = build({"kind": model_kind, "cfg": HASH})
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (batch,) + model.input_shape).astype(
        np.float32), rng.integers(0, model.num_classes, batch).astype(
            np.int32)) for _ in range(N_STEPS)]


def _job(kind, batch, layout, seed, cfg=HASH, **kw):
    return {"kind": "tp_steps", "model": {"kind": kind, "cfg": cfg},
            "layout": layout, "data": _batches(kind, batch, seed),
            "batch": batch, "lr": LR,
            "key": keys.base_key(13).tolist(), **kw}


BF16 = dict(HASH, engine="sim_bf16")
A9 = dict(HASH, bits_a=9)   # 9-bit dense operands: int8's float route
# sim with the controllers at a non-zero target: overflow counts
SIM_OVF = dict(HASH, engine="sim", target_overflow_rate=0.01)
G16 = dict(HASH, bits_g=16)  # int8's float backward


LAYOUT_JOBS = {
    "toy_single": ("tp_toy", 8, (1, 1), {"single": True}),
    "toy_1x2": ("tp_toy", 8, (1, 2), {"single": True}),
    "toy_2x1": ("tp_toy", 8, (2, 1), {}),
    "toy_2x2": ("tp_toy", 8, (2, 2), {}),
    "r8_single": ("resnet8", 4, (1, 1), {"single": True}),
    "r8_1x2": ("resnet8", 4, (1, 2), {"single": True}),
    "r8_2x1": ("resnet8", 4, (2, 1), {}),
    "r8_2x2": ("resnet8", 4, (2, 2), {}),
    "t130_single": ("tp_toy130", 8, (1, 1), {"single": True}),
    "t130_1x4": ("tp_toy130", 8, (1, 4), {"single": True}),
    "lb_psum_2x1": ("tp_toy", 8, (2, 1), {"lowbit_bits": 8}),
    "lb_psum_2x2": ("tp_toy", 8, (2, 2), {"lowbit_bits": 8}),
    "lb_int8_2x1": ("tp_toy", 8, (2, 1), {"lowbit_bits": 8,
                                          "lowbit_wire": "int8"}),
    "lb_int8_2x2": ("tp_toy", 8, (2, 2), {"lowbit_bits": 8,
                                          "lowbit_wire": "int8"}),
    "bftoy_single": ("tp_toy", 8, (1, 1), {"single": True, "cfg": BF16}),
    "bftoy_1x2": ("tp_toy", 8, (1, 2), {"single": True, "cfg": BF16}),
    "bftoy_2x1": ("tp_toy", 8, (2, 1), {"cfg": BF16}),
    "bftoy_2x2": ("tp_toy", 8, (2, 2), {"cfg": BF16}),
    "bfr8_single": ("resnet8", 4, (1, 1), {"single": True, "cfg": BF16}),
    "bfr8_1x2": ("resnet8", 4, (1, 2), {"single": True, "cfg": BF16}),
    "a9toy_single": ("tp_toy", 8, (1, 1), {"single": True, "cfg": A9}),
    "a9toy_1x2": ("tp_toy", 8, (1, 2), {"single": True, "cfg": A9}),
    "ovtoy_single": ("tp_toy", 8, (1, 1), {"single": True,
                                           "cfg": SIM_OVF}),
    "ovtoy_1x2": ("tp_toy", 8, (1, 2), {"single": True, "cfg": SIM_OVF}),
    "g16r8_single": ("resnet8", 4, (1, 1), {"single": True, "cfg": G16}),
    "g16r8_1x2": ("resnet8", 4, (1, 2), {"single": True, "cfg": G16}),
}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    jobs = {name: _job(kind, batch, layout, seed=i, **kw)
            for i, (name, (kind, batch, layout, kw))
            in enumerate(LAYOUT_JOBS.items())}
    # each pair compared draws the same batches
    for a, b in itertools.combinations(jobs, 2):
        if a.split("_")[0] == b.split("_")[0]:
            jobs[b]["data"] = jobs[a]["data"]
    return start_ranks(tmp_path_factory.mktemp("tp"), jobs, 4)(timeout=300)


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def _close_trees(a, b, path=""):
    """Integer leaves (exponents) bitwise, float leaves at rtol 1e-5,
    atol 1e-6."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close_trees(a[k], b[k], f"{path}/{k}")
    elif np.asarray(b).dtype == np.int32:
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=path)


def _assert_same_run(got, want, ebuf=False):
    assert len(got["steps"]) == len(want["steps"]) == N_STEPS
    for s, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert g["loss"] == w["loss"], f"step {s} loss"
        assert g["acc"] == w["acc"], f"step {s} accuracy"
        for part in ("params", "qstate", "velocity") + (
                ("ebuf",) if ebuf else ()):
            _equal_trees(g[part], w[part], f"step {s} {part}")


@pytest.mark.parametrize("model", ["toy", "r8"])
def test_tp_1x2_equals_one_rank_step(layouts, model):
    """tp = 2, one data rank: both model ranks hold the one-rank step's
    state, bit for bit, after each of 3 steps."""
    want = layouts[0][f"{model}_single"]
    for r in (0, 1):
        _assert_same_run(layouts[r][f"{model}_1x2"], want)
    # the controllers moved, so their statistics were read whole
    assert want["steps"][-1]["qstate"] != want["init"][1]


@pytest.mark.parametrize("model", ["toy", "r8"])
def test_dp_tp_2x2_equals_dp_2(layouts, model):
    """dp x tp = 2 x 2 against dp 2 (tp = 1) on the same rows: every rank
    of the layout holds the dp 2 run's state, bit for bit."""
    for r in range(4):
        _assert_same_run(layouts[r][f"{model}_2x2"],
                         layouts[r // 2][f"{model}_2x1"])


@pytest.mark.parametrize("run,want", [
    ("bftoy_1x2", "bftoy_single"), ("bfr8_1x2", "bfr8_single"),
    ("bftoy_2x2", "bftoy_2x1"), ("a9toy_1x2", "a9toy_single"),
    ("ovtoy_1x2", "ovtoy_single"), ("g16r8_1x2", "g16r8_single")])
def test_float_route_tp_equals_one_rank_and_dp_steps(layouts, run, want):
    """The float route on the layout: ``sim_bf16`` (each rank's exact
    f32 partial dx, summed in f32 and rounded once to bf16, as one
    rank's bf16 dot rounds; ``tests/test_torch_tp_jax.py`` says how
    ``lbt_tpu``'s GSPMD step rounds), ``int8``'s 9-bit dense operands
    (f32 partials), ``sim`` with the controllers at a 1% overflow
    target (the sharded weight's overflow counts summed over the model
    group, over the whole tensor's size), and ``int8`` with 16-bit
    cotangents on ResNet-8 (the integer forward, the sharded conv's
    float backward summing its f32 partial dx).  At 1 x 2 against the
    one-rank step, at 2 x 2 against dp 2 on the same rows: exponents
    bitwise, the loss at rtol 1e-5, the state at rtol 1e-5, atol 1e-6,
    on every rank.  The model group sums one partial dx a sharded layer
    a step: a sum left out would halve the input's gradient, a second
    one double it."""
    dp = run.endswith("2x2")
    for r in range(4 if dp else 2):
        got = layouts[r][run]
        ref = layouts[r // 2 if dp else 0][want]
        for s, (g, w) in enumerate(zip(got["steps"], ref["steps"])):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5,
                                       err_msg=f"rank {r} step {s}")
            for part in ("params", "qstate", "velocity"):
                _close_trees(g[part], w[part], f"rank {r} step {s} {part}")
    assert ref["steps"][-1]["qstate"] != ref["init"][1]

    def n_sharded(specs):
        return sum(n_sharded(v) if isinstance(v, dict) else bool(v)
                   for v in specs.values())
    assert layouts[0][run]["kinds"]["dx"][1] == N_STEPS * n_sharded(
        layouts[0][run]["specs"])


def test_tp_uneven_columns_equal_one_rank_step(layouts):
    """A 256 x 130 layer over 4 model ranks (slices of 33, 33, 33, 31
    columns) steps as on one rank."""
    assert [mesh.column_slice(130, 4, m) for m in range(4)] == [
        (0, 33), (33, 33), (66, 33), (99, 31)]
    for r in range(4):
        _assert_same_run(layouts[r]["t130_1x4"], layouts[0]["t130_single"])


def test_tp_collectives_by_kind(layouts):
    """The model group's collectives a step: joins of the forward, a
    partial-dx sum for each sharded layer whose input needs a gradient,
    and the controllers' statistics; the join's backward sums nothing."""
    kinds = layouts[0]["toy_1x2"]["kinds"]
    assert kinds["gather"][1] == N_STEPS      # d2's output, each step
    assert kinds["dx"][1] == N_STEPS          # d2's input gradient
    assert kinds["stats"][1] == N_STEPS       # d2's W controller
    r8 = layouts[0]["r8_1x2"]["kinds"]
    # the fused conv joins its BN input's codes and moments
    assert r8["gather"][1] == 2 * N_STEPS


@pytest.mark.parametrize("wire", ["psum", "int8"])
def test_tp_lowbit_allreduce_equals_dp_2(layouts, wire):
    """tp x the low-bit all-reduce: 2 x 2 equals dp 2 bitwise, ``ebuf``
    (each rank's residual, its slice gathered) included."""
    for r in range(4):
        _assert_same_run(layouts[r][f"lb_{wire}_2x2"],
                         layouts[r // 2][f"lb_{wire}_2x1"], ebuf=True)
    assert any(np.abs(v).max() > 0 for v in
               layouts[0][f"lb_{wire}_2x2"]["steps"][-1]["ebuf"]["d2"]
               .values())


# ---------------------------------------------------------------------------
# 5. the specs and the slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", [
    None, ((1, 1), "SAME", 3), ((2, 2), "SAME", 3), ((2, 2), "VALID", 1),
    ((1, 1), "VALID", 3)])
def test_sharded_bf16_contraction_equals_the_whole(geom):
    """``sim_bf16``'s contraction (``qops._BF16Contract``) whole, and on 2
    column slices of 8-bit codes (the joined forward, each slice's
    ``dW``, and the two f32 partial ``dx`` summed and rounded once to
    bf16), equals the library's bf16 contraction on the CPU, whose sums
    are exact, bitwise (a matmul; convs at stride 1 and 2, SAME and
    VALID, an odd input size)."""
    from lbt_tpu_torch.ops import qops
    gen = torch.Generator().manual_seed(3)

    def codes(shape, lim, scale):
        return torch.randint(-lim, lim, shape, generator=gen).float() * scale
    if geom is None:
        x, w = codes((12, 40), 128, 2 ** -7), codes((40, 18), 128, 2 ** -8)
        args, contract = None, torch.matmul
    else:
        strides, padding, k = geom
        x = codes((2, 9, 9, 6), 256, 2 ** -8)
        w = codes((k, k, 6, 18), 128, 2 ** -8)
        pads = conv_pads(padding, (9, 9), (k, k), strides)
        args = (strides, pads)

        def contract(a, b):
            return qops._float_conv(a, b, strides, pads)
    xb, wb = x.bfloat16().requires_grad_(), w.bfloat16().requires_grad_()
    y = contract(xb, wb)
    g = codes(tuple(y.shape), 128, 2 ** -10).bfloat16()
    y.backward(g)
    xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
    whole = qops._BF16Contract.apply(xw, ww, args, False)
    whole.backward(g)
    assert torch.equal(whole, y)
    assert torch.equal(ww.grad, wb.grad.float())
    assert torch.equal(xw.grad, xb.grad.float())
    ys, dws, dx = [], [], 0
    for col0, width in _slices(18, 2):
        xs = x.clone().requires_grad_()
        ws = w[..., col0:col0 + width].clone().requires_grad_()
        part = qops._BF16Contract.apply(xs, ws, args, True)
        part.backward(g[..., col0:col0 + width])
        ys.append(part)
        dws.append(ws.grad)
        dx = dx + xs.grad
    assert torch.equal(torch.cat(ys, -1), y)
    assert torch.equal(torch.cat(dws, -1), wb.grad.float())
    assert torch.equal(dx.bfloat16(), xb.grad)


class _TwinSlices:
    """A model group of 2 whose other rank holds a slice equal to this
    one's: a sum over it is twice this rank's."""
    world, rank = 2, 0

    def all_reduce(self, t, op="sum", kind=""):
        return t * 2 if op == "sum" else t


def test_sharded_weight_controller_rates_the_whole_tensor():
    """A sharded ``W``'s controller at a non-zero overflow target sums
    the slices' overflow counts over the model group and rates them over
    the whole ``W``'s size, as one rank's controller on the whole ``W``:
    one clipping element in each 40 x 5 half is a rate of 0.005 (under
    the 0.006 target: the exponent tightens), where rating the summed
    counts over a slice's size would read 0.01 and widen it."""
    from lbt_tpu_torch.nn.core import Ctx, site_init_exp
    from lbt_tpu_torch.nn.layers import Dense
    cfg = tconfig.QuantConfig.uniform(8, engine="sim",
                                      target_overflow_rate=0.006)
    exps = []
    for shard in (None, mesh.Shard(_TwinSlices(), 0, 5, 10)):
        layer = Dense("d", cfg, 40, 10)
        half = torch.full((40, 5), 0.01)
        half[3, 2] = 1e3      # clips at any exponent the layer starts at
        w = half if shard is not None else torch.cat([half, half], -1)
        ctx = Ctx(train=True, update=True)
        layer._ctrl(ctx, "w", 8, w, shard=shard)
        ctx.commit()
        exps.append(int(layer.exp("w")))
    assert exps[0] == exps[1] == site_init_exp(cfg, "w") - 1


def test_param_pspecs_is_lbt_tpus_rule():
    """``W`` leaves of at least 2 dims and 32K elements shard their last
    dim; biases, BN state and small weights stay whole.  ResNet-8 shards
    one conv."""
    model = build({"kind": "resnet8", "cfg": HASH})
    params, qstate, _ = convert.to_jax_numpy(model)
    specs = mesh.param_pspecs(params)
    flat = {}

    def walk(t, s, path=""):
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], s[k], f"{path}/{k}")
            else:
                flat[f"{path}/{k}"] = (t[k].shape, s[k])
    walk(params, specs)
    sharded = {k: v for k, v in flat.items() if v[1]}
    assert list(sharded.values()) == [((3, 3, 64, 64),
                                       (None, None, None, "model"))]
    named = mesh.param_pspecs(dict(model.net.named_parameters()))
    assert sum(bool(v) for v in named.values()) == 1


def test_shard_and_gather_round_trip_converter_trees():
    """``shard_params`` of a ``convert.to_jax_numpy`` tree loads into a
    sharded model through ``from_jax_numpy``; ``gather_params`` over a
    group of one rank of each slice's place gives the whole tree back."""
    model = build({"kind": "tp_toy130", "cfg": HASH})
    params, qstate, _ = convert.to_jax_numpy(model)
    specs = mesh.param_pspecs(params)
    parts = [mesh.shard_params(params, specs, 4, m) for m in range(4)]
    assert [p["d2"]["W"].shape for p in parts] == [
        (256, 33), (256, 33), (256, 33), (256, 31)]
    np.testing.assert_array_equal(
        np.concatenate([p["d2"]["W"] for p in parts], -1), params["d2"]["W"])

    class FakeGroup:
        """The all-gather of 4 ranks, each holding ``parts[r]``."""
        world, rank = 4, 0

        def all_reduce(self, t, op="sum", kind=""):
            widths = torch.tensor([[p["d2"]["W"].shape[-1]] for p in parts])
            return widths.max(0).values if op == "max" else widths.sum(0)

        def all_gather(self, t, dim=-1, kind=""):
            w = t.shape[-1]
            return torch.cat([torch.nn.functional.pad(
                torch.from_numpy(p["d2"]["W"]),
                (0, w - p["d2"]["W"].shape[-1])) for p in parts], dim)

    whole = mesh.gather_params(parts[0], specs, FakeGroup())
    _equal_trees(whole, params)
    twin = build({"kind": "tp_toy130", "cfg": HASH})
    with mock.patch.object(mesh, "column_slice",
                           lambda n, tp, i: (99, 31)):
        mesh.shard_model(twin, FakeGroup())
    convert.from_jax_numpy(twin, parts[3], qstate)
    assert twin.net.layers[2].W.shape == (256, 31)
    assert twin.net.layers[2].shard[1:] == (99, 31, 130)
