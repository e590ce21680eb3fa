"""The port's DFXP quantize (K1's plain version) held against lbt_tpu.

Every comparison is bitwise: codes are integers and multipliers powers of
two.  JAX runs on the CPU; the Pallas kernel runs in interpret mode, as
tests/test_pallas.py runs it.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lbt_tpu.ops.pallas.quant_kernels import quantize_pallas
from lbt_tpu_torch.dfxp import quantize as tq
from lbt_tpu_torch.ops.kernels import gemm, quant

# the module (lbt_tpu.dfxp re-exports a function of the same name)
jq = importlib.import_module("lbt_tpu.dfxp.quantize")

BITS = (4, 8, 9, 16)


def _exps(bits):
    return (bits - 1, 2, 0, -5, -40, jq.EXP_MIN)


def _values(bits, exp, seed=0):
    """Half-integer ties over the whole code range and past both rails,
    the rails themselves, and normal draws — all divided by the
    multiplier, so each lands where intended on the grid."""
    rng = np.random.default_rng(seed)
    mult = 2.0 ** (bits - 1 - exp)
    limit = 2 ** (bits - 1)
    span = np.arange(-limit - 3, limit + 3, dtype=np.float64)
    if span.size > 4096:
        span = np.concatenate([span[:2048], span[-2048:]])
    rails = np.array([-limit - 1, -limit - 0.5, -limit, limit - 1.5,
                      limit - 1, limit - 0.5, limit, limit + 7, 0.0, -0.0])
    normal = rng.normal(0, 0.4 * limit, 997)
    vals = np.concatenate([span + 0.5, span, rails, normal]) / mult
    return vals.astype(np.float32)


@pytest.mark.parametrize("bits", BITS)
def test_quantize_int_matches_lbt_tpu(bits):
    for exp in _exps(bits):
        x = _values(bits, exp)
        want, want_mult = jq.quantize_int(jnp.asarray(x), bits,
                                          jnp.int32(exp))
        got, got_mult = tq.quantize_int(torch.from_numpy(x), bits, exp)
        assert got.dtype == quant.code_dtype(bits)
        np.testing.assert_array_equal(
            got.numpy().astype(np.int64),
            np.asarray(want, np.float64).astype(np.int64),
            err_msg=f"bits={bits} exp={exp}")
        assert float(got_mult) == float(want_mult)
        deq = tq.quantize(torch.from_numpy(x), bits, exp)
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(jq.quantize(jnp.asarray(x), bits,
                                                jnp.int32(exp))))


@pytest.mark.parametrize("bits", BITS)
def test_multiplier_exact_over_controller_range(bits):
    exps = np.arange(jq.EXP_MIN, bits, dtype=np.int32)
    got = tq.multiplier(bits, torch.from_numpy(exps)).numpy()
    want = np.asarray(jq.multiplier(bits, jnp.asarray(exps)))
    np.testing.assert_array_equal(got, want)
    assert np.isinf(tq.multiplier(8, -200).item())


@pytest.mark.parametrize("bits", (8, 9))
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (33, 70), (3, 5, 7)])
def test_k1_plain_matches_quantize_pallas(bits, shape):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, shape).astype(np.float32)
    x.flat[:6] = np.array([0.5, -0.5, 1.5, 2.5, -2.5, 1e4]) / 2 ** (bits - 3)
    with pltpu.force_tpu_interpret_mode():
        want, want_mult = quantize_pallas(jnp.asarray(x), bits,
                                          jnp.int32(2), stochastic=False)
    got, mult = quant.quantize_codes(torch.from_numpy(x), bits, 2)
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  np.asarray(want, np.int32))
    assert float(mult) == float(want_mult)


@pytest.mark.parametrize("bits", range(2, 17))
def test_k1_plain_multiplier_matches_lbt_tpu(bits):
    """K1 builds the multiplier from the exponent it is given: its plain
    version's equals ``lbt_tpu``'s ``multiplier`` bit for bit at every
    exponent the controller reaches and at the first whose multiplier
    passes 2**127 (inf), from a device tensor or a Python int alike."""
    exps = [*range(jq.EXP_MIN, bits), bits - 1 - 128]
    want = np.asarray(jq.multiplier(bits, jnp.asarray(exps, jnp.int32)))
    assert np.isinf(want[-1])
    x = torch.zeros(3)
    for exp, w in zip(exps, want):
        for e in (exp, torch.tensor(exp, dtype=torch.int32)):
            codes, mult = quant.quantize_codes(x, bits, e)
            assert mult.dtype == torch.float32 and mult.shape == ()
            assert mult.numpy().tobytes() == w.tobytes(), (bits, exp)
            assert codes.dtype == quant.code_dtype(bits)


_KEYS = [(0, 0), (1, 2), (0xDEADBEEF, 0x12345678), (0xFFFFFFFF, 0x80000001)]


@pytest.mark.parametrize("light", [False, True])
@pytest.mark.parametrize("shape", [(4, 3, 5, 7), (1000,), (1,)])
def test_hash_uniform_matches_lbt_tpu(light, shape):
    for kd in _KEYS:
        key = jax.random.wrap_key_data(np.asarray(kd, np.uint32))
        want = np.asarray(jq.hash_uniform(key, shape, light))
        got = tq.hash_uniform(kd, shape, light).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(kd))


@pytest.mark.parametrize("backend", ["xla_hash", "xla_hash1"])
@pytest.mark.parametrize("bits", (8, 9))
def test_k1_stochastic_matches_lbt_tpu_hash(backend, bits):
    x = np.random.default_rng(2).normal(0, 1, (4, 6, 6, 16)).astype(
        np.float32)
    for kd in _KEYS:
        key = jax.random.wrap_key_data(np.asarray(kd, np.uint32))
        want, _ = jq.quantize_int(jnp.asarray(x), bits, jnp.int32(1), key,
                                  stochastic=True, backend=backend)
        got, _ = tq.quantize_int(torch.from_numpy(x), bits, 1, kd,
                                 stochastic=True, backend=backend)
        np.testing.assert_array_equal(
            got.numpy().astype(np.int32),
            np.asarray(want, np.float32).astype(np.int32),
            err_msg=f"{backend} {kd}")


@pytest.mark.parametrize("bits", (8, 9))
def test_stochastic_prng_stream_is_refused(bits):
    """What a stochastic quantize still refuses: no key, an unknown
    backend.  The ``prng`` stream (``backend='xla'``), refused before
    threefry was ported, now runs and gives ``lbt_tpu``'s codes bitwise
    (more cases in ``tests/test_torch_prng.py``)."""
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        tq.quantize_int(x, 8, 0, None, stochastic=True)
    with pytest.raises(ValueError, match="unknown quantize backend"):
        tq.quantize_int(x, 8, 0, (1, 2), stochastic=True, backend="xla_hash2")
    xs = np.random.default_rng(3).normal(0, 1, (4, 6, 6, 16)).astype(
        np.float32)
    for kd in _KEYS:
        key = jax.random.wrap_key_data(np.asarray(kd, np.uint32))
        want, _ = jq.quantize_int(jnp.asarray(xs), bits, jnp.int32(1), key,
                                  stochastic=True, backend="xla")
        got, _ = tq.quantize_int(torch.from_numpy(xs), bits, 1, kd,
                                 stochastic=True, backend="xla")
        np.testing.assert_array_equal(
            got.numpy().astype(np.int32),
            np.asarray(want, np.float32).astype(np.int32), err_msg=str(kd))


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain versions; any other device must
    launch a kernel or raise."""
    x = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no K1 kernel"):
        quant.quantize_codes(x, 8, 2)
    a = torch.empty(4, 4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no K2 kernel"):
        gemm.int8_matmul(a, a)


def test_port_imports_no_jax():
    """The port (its trainer, data sources and host build, checkpoint,
    logging, CLI, data parallelism, deployment and every registry model
    included), and chip_smoke.py's own imports
    and walk of the serving path, load no JAX, and nothing of
    ``lbt_tpu``: the card's machine has no JAX, and the port owns its
    config."""
    code = (
        "import sys, torch\n"
        "import lbt_tpu_torch\n"
        "from lbt_tpu_torch.infer import Predictor\n"
        "from lbt_tpu_torch import convert\n"
        "import lbt_tpu_torch.main, lbt_tpu_torch.train.trainer\n"
        "import lbt_tpu_torch.data.datasets, lbt_tpu_torch.data.pipeline\n"
        "import lbt_tpu_torch.data.build, lbt_tpu_torch.data.native\n"
        "import lbt_tpu_torch.data.tfrecord, lbt_tpu_torch.data.imagefolder\n"
        "from lbt_tpu_torch.train.step import debug_nans\n"
        "import lbt_tpu_torch.parallel, lbt_tpu_torch.parallel.dp\n"
        "import lbt_tpu_torch.parallel.lowbit\n"
        "import lbt_tpu_torch.parallel.multihost\n"
        "import lbt_tpu_torch.train.checkpoint, lbt_tpu_torch.utils.tb\n"
        "import lbt_tpu_torch.utils.logging, lbt_tpu_torch.utils.profiling\n"
        "from lbt_tpu_torch.infer import (fold_batchnorm,\n"
        "    export_quantized_weights, restore_quantized_weights,\n"
        "    exported_nbytes)\n"
        "from lbt_tpu_torch.nn.layers import Dropout, GradientBuffer\n"
        "from lbt_tpu_torch.config import QuantConfig\n"
        "from lbt_tpu_torch.models import MODEL_REGISTRY, build_model\n"
        "for name in MODEL_REGISTRY:\n"
        "    build_model(name, QuantConfig.uniform(8))\n"
        "build_model('CIFAR10_Resnet20', QuantConfig.uniform(8),\n"
        "            gradient_buffer_batch=4)\n"
        "import chip_smoke\n"
        "chip_smoke.v_config(), chip_smoke.build_vgg16(0)\n"
        "qmod, qops, build, gemm, quant = chip_smoke.port_modules()\n"
        "m = chip_smoke.build_resnet20(0)\n"
        "k1, k2 = chip_smoke.record_path_calls(\n"
        "    m, torch.zeros(2, 32, 32, 3), qmod, qops, quant, gemm)\n"
        "assert sum(k1.values()) == 128 and sum(k2.values()) == 43, (k1, k2)\n"
        "Predictor(m, device='cpu')(torch.zeros(1, 32, 32, 3))\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'lbt_tpu'"
        "], 'lbt_tpu was imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
