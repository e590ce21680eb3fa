"""The plain reference against the port on the CPU, at the tiny twin of
each cell: the same weights, keys and batches through both, three steps;
and the reference's independence of the port."""

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import CELLS, ROOT, TWIN_BATCH

from portbench import check, harness
from portbench.reference import resnet


@pytest.mark.parametrize("workload", CELLS)
def test_reference_follows_the_port(twin, workload):
    """Three steps of the port's own train step and of the reference from
    the same start agree in every compared number, in each exponent, and
    in every parameter bit for bit (the port's plain kernels on the CPU)."""
    from lbt_tpu_torch.config import QuantConfig, TrainConfig
    from lbt_tpu_torch.dfxp.keys import base_key
    from lbt_tpu_torch.models import build_model
    from lbt_tpu_torch.train.optim import momentum_init
    from lbt_tpu_torch.train.step import make_train_step

    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        workload, here=twin)
    cfg, spec = cell.cfg, cell.spec
    params = harness.initial_params(cell, 77, "cpu")
    model = build_model(cfg["model"]["zoo"], QuantConfig(**cfg["quant"]),
                        num_classes=spec.num_classes,
                        image_size=spec.image_size,
                        weight_decay=spec.weight_decay)
    with torch.no_grad():
        for k, p in model.net.named_parameters():
            p.copy_(params[k])
    step = make_train_step(model, TrainConfig(batch_size=TWIN_BATCH))
    vel = momentum_init(dict(model.net.named_parameters()))
    ref = resnet.Reference(spec, params, 5)
    rng = np.random.default_rng(0)
    for i in range(3):
        x = torch.from_numpy(rng.standard_normal(
            (TWIN_BATCH, spec.image_size, spec.image_size, 3),
            dtype=np.float32))
        y = torch.from_numpy(rng.integers(0, spec.num_classes, TWIN_BATCH))
        lp = step(model, vel, x, y, 200 + i, spec.lr, base_key(5))
        assert lp["loss"].item() == ref.step(x, y, 200 + i)
    for k, p in model.net.named_parameters():
        assert torch.equal(p.detach(), ref.params[k].detach()), k
        assert torch.equal(vel[k], ref.velocity[k]), k
    sd = model.net.state_dict()
    for k, v in ref.exponents().items():
        assert int(sd[k]) == v, k
    for k, v in ref.buffers.items():
        assert torch.equal(sd[k], v), k


def test_the_reference_imports_nothing_of_the_port():
    """``portbench.reference`` names no module of ``lbt_tpu_torch`` or
    ``lbt_tpu`` (by whole top-level name), and importing it loads none."""
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "lbt_tpu_torch", "lbt_tpu", "jax"), (path, n)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import portbench.reference.resnet, "
         "portbench.yardstick.flops; print(sorted({m.split('.')[0] for m "
         "in sys.modules} & {'lbt_tpu_torch', 'lbt_tpu', 'jax'}))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_nothing_reads_the_jax_benchmarks():
    """No file of the harness imports or opens ``bench.py``,
    ``chip_smoke.py`` or ``benchmarks/``."""
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                for n in names:
                    assert (n or "").split(".")[0] not in (
                        "bench", "chip_smoke", "benchmarks"), (path, n)
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and " " not in node.value):
                v = node.value
                assert not (v.endswith(("bench.py", "chip_smoke.py"))
                            or v.startswith("benchmarks")), (path, v)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(twin, workload):
    """The control, the reference at 4-bit codes in the program's place,
    reads over the cell's limits at the twin's size."""
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        workload, here=twin)
    pool = [(np.random.default_rng(i).standard_normal(
        (TWIN_BATCH, 32, 32, 3), dtype=np.float32),
        np.arange(TWIN_BATCH) % 10) for i in range(4)]
    want = harness.reference_readings(cell, 9, pool, "cpu")
    low = resnet.Spec.from_config(cell.cfg, bits_w=4, bits_a=4, bits_b=4,
                                  bits_g=4)
    got = harness.reference_readings(cell, 9, pool, "cpu", spec=low)
    nums = check.numbers(got, want)
    assert not check.judge(nums, cell.limits["limits"]), nums


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_readings_on_the_card(card, workload):
    """At the cell's own size on the card, three seeds: the program's
    compared steps pass the limits; the 4-bit control and the half-batch
    fault fail them (``portbench/readings.py``)."""
    from portbench import readings
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        workload)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        rows = {r["kind"]: r for r in readings.seed_readings(
            cell, seed, card, control=True, half=True)}
        lim = cell.limits["limits"]
        assert all(rows["sound"]["numbers"][k] <= v for k, v in lim.items())
        for kind in ("control", "half_batch"):
            assert any(rows[kind]["numbers"][k] > v
                       for k, v in lim.items()), kind
