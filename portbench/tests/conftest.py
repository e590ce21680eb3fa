"""Tests of the benchmark.  CPU tests run here; tests marked ``cuda`` need
a CUDA card and skip without one (the fixture ``card`` decides, when the
test runs).  A tiny twin of each cell (ResNet-50 at 32 px, 10 classes,
batch 4) stands for the cell on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TWIN_MODEL = {"image_size": 32, "num_classes": 10}
TWIN_BATCH = 4
CELLS = ("r50-int8-train-b256", "r50-simbf16-train-b256")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def twin_dir(tmp: Path) -> Path:
    """A copy of ``portbench/`` whose configurations and traffic are the
    tiny twins'; returns its ``portbench`` directory."""
    here = tmp / "portbench"
    shutil.copytree(ROOT / "portbench", here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for c in bench()["configs"]:
        p = tmp / c["file"]
        cfg = json.loads(p.read_text())
        cfg["model"].update(TWIN_MODEL)
        p.write_text(json.dumps(cfg))
    for p in (here / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix["batch_size"] = TWIN_BATCH
        p.write_text(json.dumps(mix))
    return here


@pytest.fixture(scope="module")
def twin(tmp_path_factory) -> Path:
    return twin_dir(tmp_path_factory.mktemp("twin"))
