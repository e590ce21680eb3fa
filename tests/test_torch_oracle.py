"""The port's model held against the independent NumPy oracle
(``tests/oracle.py``), the counterpart of ``tests/test_model_oracle.py``
for ``lbt_tpu_torch``: the reference semantics re-derived from scratch in
NumPy (padding, bias quantization order, BN moments, controller timing,
weight-decay placement), and a small conv + pool + BN + dense network
trained for full steps through the port's ``make_train_step`` on the
CPU, from the port's seeded init.

* ``uniform(8)`` on the ``sim`` engine, deterministic rounding: 4 steps,
  the loss at rtol 2e-5 (atol 1e-6), parameters at rtol 2e-4 (atol
  2e-5), BN running statistics at rtol 1e-4 (atol 1e-6) and every
  exponent trajectory bitwise;
* the FP32 pass-through (``uniform(32)``): 2 steps of plain float
  training at the same tolerances.

These are ``tests/test_model_oracle.py``'s tolerances; this file imports
no JAX.
"""

import numpy as np
import torch

import oracle
from lbt_tpu_torch import convert
from lbt_tpu_torch.config import QuantConfig, TrainConfig
from lbt_tpu_torch.dfxp.keys import base_key
from lbt_tpu_torch.nn.layers import Conv2d, Dense, Flatten, MaxPool, ReLU
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.nn.norm import BatchNorm
from lbt_tpu_torch.train.optim import momentum_init
from lbt_tpu_torch.train.step import make_train_step

pytest_plugins = ["torch_suite"]

WD = 0.01
LR = 0.05


def _port_model(bits):
    cfg = QuantConfig.uniform(bits, stochastic=False, engine="sim")
    model = Model("oracle_net", [
        Conv2d("conv1", cfg, (5, 5, 1, 4), (1, 1), "SAME", use_bias=True,
               weight_decay=WD),
        ReLU(),
        MaxPool(ksize=(2, 2), strides=(2, 2), padding="VALID"),
        Conv2d("conv2", cfg, (3, 3, 4, 8), (1, 1), "VALID",
               use_bias=False, weight_decay=WD),
        BatchNorm("bn1", cfg, 8, weight_decay=WD),
        ReLU(),
        Flatten(),
        Dense("dense1", cfg, 32, 10, use_bias=True, weight_decay=WD),
    ], input_shape=(8, 8, 1), num_classes=10, cfg=cfg)
    return model.init(torch.Generator().manual_seed(3))


def _oracle(p, bits):
    return oracle.RefModel([
        oracle.RefConv2d(p["conv1"]["W"].copy(), p["conv1"]["b"].copy(),
                         1, "SAME", bits, WD),
        oracle.RefReLU(),
        oracle.RefMaxPool(2, 2),
        oracle.RefConv2d(p["conv2"]["W"].copy(), None, 1, "VALID",
                         bits, WD),
        oracle.RefNorm(8, bits, momentum=0.999),
        oracle.RefRescale(p["bn1"]["rescale"]["gamma"].copy(),
                          p["bn1"]["rescale"]["beta"].copy(), bits, WD),
        oracle.RefReLU(),
        oracle.RefFlatten(),
        oracle.RefDense(p["dense1"]["W"].copy(), p["dense1"]["b"].copy(),
                        bits, WD),
    ])


def _exponents(qstate, path=()):
    """``{path: int}`` of every exponent in a ``convert`` qstate tree."""
    out = {}
    for k, v in qstate.items():
        if isinstance(v, dict):
            out.update(_exponents(v, path + (k,)))
        elif "exp" in path:
            out[path + (k,)] = int(v)
    return out


def _train(bits, n_steps, seed):
    """``(port model, oracle)`` after ``n_steps`` steps each on the same
    batches, each step's loss compared on the way."""
    model = _port_model(bits)
    ref = _oracle(convert.to_jax_numpy(model)[0], bits)
    vel = momentum_init(dict(model.net.named_parameters()))
    step = make_train_step(model, TrainConfig(lr=LR, momentum=0.9,
                                              weight_decay=WD, batch_size=8))
    rng = np.random.default_rng(seed)
    # inputs scaled like reference-preprocessed images (~[-1, 1])
    xs = rng.normal(0, 0.7, (n_steps, 8, 8, 8, 1)).astype(np.float32)
    ys = rng.integers(0, 10, (n_steps, 8)).astype(np.int32)
    for s in range(n_steps):
        m = step(model, vel, torch.from_numpy(xs[s]),
                 torch.from_numpy(ys[s]), s, LR, base_key(11))
        loss_ref, _ = ref.train_step(xs[s], ys[s], LR)
        np.testing.assert_allclose(m["loss"].item(), loss_ref, rtol=2e-5,
                                   atol=1e-6, err_msg=f"loss at step {s}")
    return model, ref


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                               err_msg=name)


def test_sim_engine_matches_numpy_oracle():
    """``uniform(8)`` on ``sim``: 4 steps against the oracle, exponent
    trajectories bitwise."""
    model, ref = _train(8, 4, seed=5)
    p, q, _ = convert.to_jax_numpy(model)
    o = ref.layers
    for name, got, want in [
            ("conv1.W", p["conv1"]["W"], o[0].W),
            ("conv1.b", p["conv1"]["b"], o[0].b),
            ("conv2.W", p["conv2"]["W"], o[3].W),
            ("bn1.gamma", p["bn1"]["rescale"]["gamma"], o[5].gamma),
            ("bn1.beta", p["bn1"]["rescale"]["beta"], o[5].beta),
            ("dense1.W", p["dense1"]["W"], o[8].W),
            ("dense1.b", p["dense1"]["b"], o[8].b)]:
        _close(got, want, name)
    state = q["bn1"]["norm"]["state"]
    np.testing.assert_allclose(state["mean"], o[4].run_mean, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(state["var"], o[4].run_var, rtol=1e-4,
                               atol=1e-6)
    want_exps = {
        "conv1": {"x": o[0].sx, "w": o[0].sw, "b": o[0].sb, "grad": o[0].sg},
        "conv2": {"x": o[3].sx, "w": o[3].sw, "grad": o[3].sg},
        "bn1.norm": {"x": o[4].sx, "grad": o[4].sg},
        "bn1.rescale": {"x": o[5].sx, "gamma": o[5].sgam,
                        "beta": o[5].sbet, "grad": o[5].sg},
        "dense1": {"x": o[8].sx, "w": o[8].sw, "b": o[8].sb,
                   "grad": o[8].sg},
    }
    exps = _exponents(q)
    assert len(exps) == sum(len(v) for v in want_exps.values())
    for keys, got in exps.items():
        layer = keys[0] if keys[0] != "bn1" else f"bn1.{keys[1]}"
        assert got == want_exps[layer][keys[-1]].exp, (
            f"exponent at {keys}: port {got}, oracle "
            f"{want_exps[layer][keys[-1]].exp}")


def test_fp32_passthrough_matches_oracle():
    """``bits = 32``: both sides are plain float training (the
    reference's pass-through); 2 steps."""
    model, ref = _train(32, 2, seed=6)
    p = convert.to_jax_numpy(model)[0]
    _close(p["conv1"]["W"], ref.layers[0].W, "conv1.W")
    _close(p["dense1"]["W"], ref.layers[8].W, "dense1.W")
    _close(p["conv2"]["W"], ref.layers[3].W, "conv2.W")
