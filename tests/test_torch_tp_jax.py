"""The port's tensor-parallel step held against ``lbt_tpu``'s GSPMD step on
the CPU, the counterpart of ``tests/test_parallel.py:_tp_equiv_check``:
``lbt_tpu``'s ``make_train_step`` jitted over parameters laid out by
``param_pspecs`` on a 1 x 2 mesh of 2 of the 8 virtual CPU devices
(``tests/conftest.py``), against the port's one-rank step on a model cut
by ``shard_model`` over 2 rank processes (``tests/torch_ranks.py``).
Weights from the port's seeded init, carried across by ``convert``;
inputs from numpy seeds.  3 steps of the Dense toy (20-256-128-4) and the
conv toy (a 3x3x64x64 conv sharded, fused with its BN on the integer
route), on the integer route (``int8``, deterministic and under
``noise_mode='hash'``) and on the float route: ``sim`` + ``hash`` (both
toys), ``sim_bf16`` + ``prng`` (jitted without excess precision, ROADMAP
queue 3 case 5), ``int8`` with 16-bit cotangents (the float backward) and
``QuantConfig.fp32()``; and the conv toy under ``unsafe_rbg`` keys with
``prng`` noise (``benchmarks/ablate.py``'s ``rbg-int8``): GSPMD draws
each shard's ``rng_bit_generator`` bits where the whole tensor's stream
has them, as the port's column window places the Philox counter.
Exponents bitwise; floats at rtol 1e-5, atol 1e-6, the loss at rtol
1e-5.

``sim_bf16`` sums bf16 partials, and the two steps round them
differently.  ``lbt_tpu``'s compiled step all-reduces each rank's
bf16-rounded partial as bf16 (the HLO's all-reduce is bf16,
``add.clone_promoted``: XLA on the CPU adds in f32 and rounds after, so
at tp = 2 one bf16 add of two rounded partials), and GSPMD keeps the
sharded layer's output sharded and contracts the next layer's input over
those channels the same way.  The port departs from that on purpose: it
rounds once, as one rank's bf16 dot, summing the f32 partial ``dx`` and
rounding the sum to bf16 (``ops/qops.py:_BF16Contract``), and it joins
the output and contracts the next layer whole, so that its step at
tp = 2 rounds where its one-rank step does (``chip_smoke.py`` leg (d)).
Where the double rounding falls otherwise, a value differs by a bf16 ulp
(2**-8 relative): the logits here.  So ``sim_bf16``'s loss is held at
rtol 4e-4, twice the largest gap measured (1.7e-4, at step 2); the
state, which sees the logits and the ``dx`` only through 8-bit cotangent
codes, at the f32 tolerance above, and its exponents bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import lbt_tpu.config as jconfig
from lbt_tpu.nn import AvgPool as JAvgPool
from lbt_tpu.nn import BatchNorm as JBatchNorm
from lbt_tpu.nn import Conv2d as JConv2d
from lbt_tpu.nn import Dense as JDense
from lbt_tpu.nn import Flatten as JFlatten
from lbt_tpu.nn import ReLU as JReLU
from lbt_tpu.nn.model import Model as JModel
from lbt_tpu.parallel.mesh import make_mesh, param_pspecs, to_shardings
from lbt_tpu.train.optim import momentum_init as jmomentum_init
from lbt_tpu.train.step import make_train_step as jmake_train_step
from lbt_tpu_torch.dfxp import keys
from test_torch_parallel import close_trees
from test_torch_train import NO_EXCESS_PRECISION
from torch_ranks import quant_config, start_ranks

pytest_plugins = ["torch_suite"]

KEY_SEED, LR, BATCH, N_STEPS = 9, 0.05, 8, 3
INT8, SIM, HASH = {"engine": "int8"}, {"engine": "sim"}, {"noise_mode": "hash"}
# name: (model, bits of QuantConfig.uniform, its keywords)
CASES = {
    "toy_det": ("tp_toy", 8, dict(INT8, stochastic=False)),
    "toy_hash": ("tp_toy", 8, dict(INT8, **HASH)),
    "conv_det": ("tp_convtoy", 8, dict(INT8, stochastic=False)),
    "conv_hash": ("tp_convtoy", 8, dict(INT8, **HASH)),
    "toy_sim_hash": ("tp_toy", 8, dict(SIM, **HASH)),
    "conv_sim_hash": ("tp_convtoy", 8, dict(SIM, **HASH)),
    "toy_bf16_prng": ("tp_toy", 8, {"engine": "sim_bf16",
                                    "noise_mode": "prng"}),
    "toy_g16": ("tp_toy", 8, dict(INT8, bits_g=16, **HASH)),
    "toy_fp32": ("tp_toy", 32, {}),
    "conv_rbg_prng": ("tp_convtoy", 8, dict(INT8, noise_mode="prng",
                                            noise_impl="unsafe_rbg")),
}
# sim_bf16's bound on the loss (the docstring)
BF16_LOSS_RTOL = 4e-4


def _jax_model(kind, bits, cfg_kw):
    cfg = quant_config(bits, cfg_kw, jconfig.QuantConfig)
    if kind == "tp_toy":
        return JModel("tp_toy", [
            JDense("d1", cfg, 20, 256), JReLU(), JDense("d2", cfg, 256, 128),
            JReLU(), JDense("d3", cfg, 128, 4)],
            input_shape=(20,), num_classes=4, cfg=cfg)
    return JModel("convtoy", [
        JConv2d("c1", cfg, (3, 3, 3, 64), use_bias=False),
        JBatchNorm("bn1", cfg, 64), JReLU(),
        JConv2d("c2", cfg, (3, 3, 64, 64), use_bias=False),
        JBatchNorm("bn2", cfg, 64), JReLU(),
        JAvgPool(ksize=(8, 8), strides=(8, 8)), JFlatten(dim=64),
        JDense("fc", cfg, 64, 4)],
        input_shape=(8, 8, 3), num_classes=4, cfg=cfg)


def _data(kind, seed):
    shape = (BATCH, 20) if kind == "tp_toy" else (BATCH, 8, 8, 3)
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, shape).astype(np.float32),
             rng.integers(0, 4, BATCH).astype(np.int32))
            for _ in range(N_STEPS)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    jobs = {name: {"kind": "tp_steps", "single": True, "layout": (1, 2),
                   "model": {"kind": kind, "bits": bits, "cfg": cfg_kw},
                   "data": _data(kind, i), "batch": BATCH, "lr": LR,
                   "key": keys.base_key(
                       KEY_SEED, cfg_kw.get("noise_impl", "threefry2x32")
                   ).tolist()}
            for i, (name, (kind, bits, cfg_kw)) in enumerate(CASES.items())}
    return start_ranks(tmp_path_factory.mktemp("tpjax"), jobs, 2)()


def _gspmd_steps(kind, bits, cfg_kw, init, data):
    """``lbt_tpu``'s train step jitted over its ``param_pspecs`` layout on
    a 1 x 2 mesh, from the port's initial trees."""
    jm = _jax_model(kind, bits, cfg_kw)
    mesh = make_mesh(data=1, model=2, devices=jax.devices()[:2])
    params, qstate, _ = init
    pspecs = param_pspecs(params)
    assert any("model" in str(s) for s in jax.tree.leaves(
        pspecs, is_leaf=lambda s: isinstance(s, P))), "nothing tp-sharded"
    sh = to_shardings(mesh, pspecs)
    params = jax.device_put(jax.tree.map(jnp.asarray, params), sh)
    vel = jax.device_put(jmomentum_init(params), sh)
    qstate = jax.device_put(jax.tree.map(jnp.asarray, qstate),
                            NamedSharding(mesh, P()))
    step = jax.jit(jmake_train_step(jm, jconfig.TrainConfig(), jit=False),
                   compiler_options=NO_EXCESS_PRECISION
                   if jm.cfg.engine == "sim_bf16" else None)
    out = []
    for s, (x, y) in enumerate(data):
        xs = jax.device_put(x, NamedSharding(mesh, P("data")))
        params, qstate, vel, m = step(params, qstate, vel, xs,
                                      jnp.asarray(y), jnp.int32(s),
                                      jnp.float32(LR),
                                      jax.random.key(KEY_SEED,
                                                     impl=jm.cfg.noise_impl))
        out.append((float(m["loss"]), jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, qstate),
                    jax.tree.map(np.asarray, vel)))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_step_matches_lbt_tpu_gspmd(port, case):
    """Both model ranks' whole state after each step against ``lbt_tpu``'s
    sharded step: exponents bitwise, floats at rtol 1e-5, atol 1e-6, the
    loss at rtol 1e-5 (``sim_bf16``'s at the module docstring's bound)."""
    kind, bits, cfg_kw = CASES[case]
    i = list(CASES).index(case)
    want = _gspmd_steps(kind, bits, cfg_kw, port[0][case]["init"],
                        _data(kind, i))
    loss_rtol = (BF16_LOSS_RTOL if cfg_kw.get("engine") == "sim_bf16"
                 else 1e-5)
    for r in (0, 1):
        got = port[r][case]["steps"]
        for s, (loss, params, qstate, vel) in enumerate(want):
            np.testing.assert_allclose(got[s]["loss"], loss, rtol=loss_rtol,
                                       err_msg=f"rank {r} step {s}")
            close_trees(got[s]["params"], params, f"rank {r} step {s}")
            close_trees(got[s]["qstate"], qstate, f"rank {r} step {s}")
            close_trees(got[s]["velocity"], vel, f"rank {r} step {s}")
