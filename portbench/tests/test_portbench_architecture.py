"""A configuration of another architecture takes only new files: the
PI-MNIST MLP (its reference, inputs, operation count, limits and a kernel
file, kept in ``tests/mlp/``) runs a whole traced cell in a twin of
``portbench/`` whose existing files stay as they were; inputs of any
dtype and shape pass through the pool as drawn; and the ResNet cells'
pool, weights and readings are those of the harness before it took an
architecture by name."""

import ast
import hashlib
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import CELLS, bench, twin_dir
from test_portbench_harness import _half_batch

from portbench import generator, harness
from portbench.reference import resnet

MLP = Path(__file__).resolve().parent / "mlp"
# where each of the MLP's files goes in a portbench directory
MLP_FILES = {"reference.py": "reference/mlp.py", "count.py": "counts/mlp.py",
             "kernel.py": "kernels/qmatmul.py",
             "config.json": "configs/pi-mnist-dfxp8-int8.json",
             "limits.json": "limits/pi-mnist-int8-train.json"}
MLP_CELL = "pi-mnist-int8-train"


def _digests(here: Path):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in here.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def _with_mlp(here: Path) -> dict:
    """The MLP's files copied into ``here`` and ``BENCHMARK.json``'s dict
    with its configuration and cell."""
    for src, dst in MLP_FILES.items():
        shutil.copy(MLP / src, here / dst)
    b = bench()
    b["configs"].append({"name": "pi-mnist-dfxp8-int8",
                         "source": "lbt_tpu_torch/models/zoo.py",
                         "file": "portbench/configs/pi-mnist-dfxp8-int8.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": MLP_CELL, "config": "pi-mnist-dfxp8-int8",
                           "traffic": "train", "chips": 1, "why": "test"})
    for m in b["per_layer"]:
        if m["name"] == "mfu.train":
            m["workloads"].append(MLP_CELL)
    return b


def test_the_mlp_reference_imports_nothing_of_the_port():
    for node in ast.walk(ast.parse((MLP / "reference.py").read_text())):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            assert n.split(".")[0] not in ("lbt_tpu_torch", "lbt_tpu",
                                           "jax"), n


def test_a_second_architecture_takes_only_new_files(tmp_path):
    """A traced run of the MLP cell reads ``correct``, with its kernel
    file's calls in the record and its count as the operations; the
    half-batch fault reads not correct; no file that was in the twin
    before changed."""
    here = twin_dir(tmp_path)
    before = _digests(here)
    b = _with_mlp(here)
    cell = harness.Cell(b, MLP_CELL, here=here)
    assert "bn" not in cell.limits["limits"]
    res = harness.run_cell(cell, 2 ** 31 + 11, 0.3, True, "cpu",
                           time.perf_counter())
    assert res["correct"], res["numbers"]
    assert set(res["numbers"]) == {"loss", "grad", "change", "exps_differ"}
    calls = res["record"]["profile"]["calls"]
    steps = res["record"]["profile"]["steps"]
    assert calls["qmatmul"][:3] == [(4, 784, 1024), (4, 1024, 1024),
                                    (4, 1024, 10)]
    assert len(calls["qmatmul"]) == 3 * steps
    assert len(calls["k2_tn"]) == 3 * steps
    assert res["record"]["train_ops_per_image"] == 2 * (
        3 * (784 * 1024 + 1024 * 1024 + 1024 * 10) - 784 * 1024)
    line = harness.result_line(cell, res, True, "cpu", 1)
    assert set(line["checks"]) == {"loss", "grad", "change"}
    assert line["metrics"]["mfu.train"]["value"] > 0
    broken = harness.run_cell(cell, 5, 0.2, False, "cpu",
                              time.perf_counter(),
                              faults=_half_batch(None))
    assert not broken["correct"], broken["numbers"]
    assert {p: d for p, d in _digests(here).items() if p in before} == before


def test_the_readings_take_the_control_from_the_cell_s_architecture(
        tmp_path):
    """``readings.py`` on the MLP cell: sound runs pass its limits, its
    4-bit control (the MLP reference at 4 bits) and the half-batch fault
    fail them, and no number is read for ``bn``."""
    from portbench import readings
    here = twin_dir(tmp_path)
    cell = harness.Cell(_with_mlp(here), MLP_CELL, here=here)
    rows = {r["kind"]: r for r in readings.seed_readings(
        cell, 12345, "cpu", control=True, half=True)}
    lim = cell.limits["limits"]
    assert set(rows["sound"]["numbers"]) == set(lim)
    assert all(rows["sound"]["numbers"][k] <= v for k, v in lim.items())
    for kind in ("control", "half_batch"):
        assert any(rows[kind]["numbers"][k] > v for k, v in lim.items())


def test_inputs_pass_through_the_pool_as_drawn(tmp_path):
    """An architecture that draws int64 token ids ``[b, s]`` and per-token
    targets finds them in the pool with their dtype, shape and values."""
    here = twin_dir(tmp_path)
    (here / "reference/tokens.py").write_text(
        "import torch\n\n\n"
        "class Spec:\n"
        "    @classmethod\n"
        "    def from_config(cls, cfg, **quant):\n"
        "        return cls()\n\n\n"
        "def draw(spec, b, gen, device):\n"
        "    ids = torch.randint(0, 50000, (b, 7), generator=gen,\n"
        "                        device=device)\n"
        "    return ids, torch.roll(ids, -1, 1)\n")
    (here / "counts/tokens.py").write_text(
        "def train_ops_per_sample(spec):\n    return 1\n")
    cfg = json.loads((here / "configs/resnet50-dfxp8-int8.json").read_text())
    cfg["architecture"]["reference"] = "tokens"
    (here / "configs/tokens.json").write_text(json.dumps(cfg))
    b = bench()
    b["configs"].append({"name": "tokens", "source": "test",
                         "file": "portbench/configs/tokens.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tokens-train", "config": "tokens",
                           "traffic": "train", "chips": 1, "why": "test"})
    (here / "limits/tokens-train.json").write_text("{}")
    cell = harness.Cell(b, "tokens-train", here=here)
    pool = generator.pool(cell.mix, cell.draw, 3, torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    for x, y in pool:
        ids = torch.randint(0, 50000, (cell.mix["batch_size"], 7),
                            generator=gen)
        assert x.dtype == y.dtype == np.int64
        assert x.shape == y.shape == (cell.mix["batch_size"], 7)
        assert np.array_equal(x, ids.numpy())
        assert np.array_equal(y, np.roll(x, -1, 1))


def _old_pool(mix, image_size, num_classes, seed, device):
    """``generator.pool`` as it was before it took the architecture's draw:
    the expected pool of the ResNet cells."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = mix["batch_size"]
    out = []
    for _ in range(mix["pool_batches"]):
        x = torch.randn((b, image_size, image_size, 3), generator=gen,
                        device=device, dtype=torch.float32)
        y = torch.randint(0, num_classes, (b,), generator=gen, device=device,
                          dtype=torch.int64)
        out.append((x.cpu().numpy(), y.cpu().numpy()))
    return out


# sha256 of the JSON of set_up's and reference_readings' readings
# ({"program": ..., "reference": ...}, sorted keys) at seed 2**31 + 7 on
# the twins, from the harness before it took an architecture by name
# (the same at 1 and 4 threads, torch 2.13 on the CPU)
PINNED = {
    "r50-int8-train-b256":
        "8525af26837173fac3e4514ad970a68eeac16aa3f48b41c173584fccb66d0521",
    "r50-simbf16-train-b256":
        "a0803d2d6d5da3b03bb869592d4f4ca4608a2056f1d73502cae3b553409555b5",
}


@pytest.mark.parametrize("workload", CELLS)
def test_the_resnet_readings_are_pinned(twin, workload):
    """The twin's pool is the old generator's to the byte, its weights
    ``resnet.init_params``' and its readings the old harness's."""
    cell = harness.Cell(bench(), workload, here=twin)
    seed = 2 ** 31 + 7
    cpu = torch.device("cpu")
    spec = resnet.Spec.from_config(cell.cfg)
    want = _old_pool(cell.mix, spec.image_size, spec.num_classes, seed + 1,
                      cpu)
    got = generator.pool(cell.mix, cell.draw, seed + 1, cpu)
    assert [(x.dtype, x.shape, x.tobytes(), y.dtype, y.tobytes())
            for x, y in got] == [(x.dtype, x.shape, x.tobytes(), y.dtype,
                                  y.tobytes()) for x, y in want]
    mine = harness.initial_params(cell, seed, cpu)
    theirs = resnet.init_params(spec, torch.Generator().manual_seed(seed),
                                cpu)
    assert list(mine) == list(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
    prog, pool, read = harness.set_up(cell, seed, cpu)
    del prog
    ref = harness.reference_readings(cell, seed, pool, cpu)
    blob = json.dumps({"program": read, "reference": ref}, sort_keys=True)
    assert hashlib.sha256(blob.encode()).hexdigest() == PINNED[workload]


# ``trace.KERNELS`` before the kernels became files
OLD_KERNELS = {"k1": ("k1_quantize_kernel",),
                "k2": ("int8_gemm_kernel", "int8_gemm_tn_kernel"),
                "fused": ("conv_fused_kernel",)}


def _old_recorded_calls():
    """``program.recorded_calls`` and ``counters`` as they were before the
    kernels became files."""
    import collections
    import contextlib
    from unittest import mock

    from lbt_tpu_torch.dfxp import quantize as qmod
    from lbt_tpu_torch.ops import qops
    from lbt_tpu_torch.ops.kernels import conv_fused, gemm, quant

    def counters():
        return {"k1": quant.quantize_codes.launches,
                "k2": gemm.int8_matmul.launches,
                "k2_tn": gemm.int8_matmul_tn.launches,
                "conv3x3": conv_fused.conv3x3_fused.launches,
                "conv1x1": conv_fused.conv1x1_fused.launches}

    @contextlib.contextmanager
    def recorded_calls():
        calls = collections.defaultdict(list)

        def k1(x, bits, exp, noise=None, stats=False):
            out = quant.quantize_codes(x, bits, exp, noise, stats)
            calls["k1"].append((x.numel(), out[0].element_size(),
                                bool(stats),
                                0 if noise is None else noise.mode))
            return out

        def k2(a, b, inv=None):
            calls["k2"].append((a.shape[0], a.shape[1], b.shape[1],
                                inv is not None))
            return gemm.int8_matmul(a, b, inv)

        def k2_tn(a, b):
            calls["k2_tn"].append((a.shape[0], a.shape[1], b.shape[1]))
            return gemm.int8_matmul_tn(a, b)

        def fused(fn):
            def rec(xc, wc, inv, mult, *, strides, pads, bits_out=8,
                    noise=None, round_bf16=False):
                calls["conv"].append((tuple(xc.shape), xc.element_size(),
                                      tuple(wc.shape), tuple(strides),
                                      tuple(map(tuple, pads)),
                                      0 if noise is None else noise.mode))
                return fn(xc, wc, inv, mult, strides=strides, pads=pads,
                          bits_out=bits_out, noise=noise,
                          round_bf16=round_bf16)
            return rec

        with mock.patch.object(qmod, "quantize_codes", k1), \
                mock.patch.object(qops, "int8_matmul", k2), \
                mock.patch.object(qops, "int8_matmul_tn", k2_tn), \
                mock.patch.object(qops, "conv3x3_fused",
                                  fused(conv_fused.conv3x3_fused)), \
                mock.patch.object(qops, "conv1x1_fused",
                                  fused(conv_fused.conv1x1_fused)):
            yield calls

    return recorded_calls, counters


@pytest.mark.parametrize("workload", CELLS)
def test_the_kernel_files_record_what_the_wrappers_did(twin, workload):
    """A twin step records under the kernel files the calls, keys and
    counts that the hard-coded wrappers recorded, and the files class
    every device name as the old table did."""
    from portbench import program, trace
    cell = harness.Cell(bench(), workload, here=twin)
    pool = generator.pool({**cell.mix, "pool_batches": 1}, cell.draw, 5,
                          torch.device("cpu"))
    old_calls, old_counters = _old_recorded_calls()
    got = []
    for recorder, count in ((old_calls, old_counters),
                            (program.recorded_calls, program.counters)):
        prog = program.Program(cell.cfg, cell.mix["batch_size"], 5, 200,
                               "cpu")
        before = count()
        with recorder() as calls:
            prog.run(generator.first(pool, 1))
        got.append((dict(calls),
                    {k: v - before[k] for k, v in count().items()}))
    assert got[0] == got[1] and got[0][0]
    names = ["void int8_gemm_kernel<64, 1>(Args)", "int8_gemm_tn_kernel<1>",
             "void__anonymous_namespace_::k1_quantize_kernel_signed_char_",
             "void conv_fused_kernel<3, 3, 1, 64>", "elementwise_kernel"]
    for name in names:
        old = next((c for c, ns in OLD_KERNELS.items()
                    if any(n in name for n in ns)), None)
        assert trace.kernel_class(name) == old, name
