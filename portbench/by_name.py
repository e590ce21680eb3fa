"""The benchmark's files found by name: ``<here>/<kind>/<name>.py``, where
``here`` is a ``portbench`` directory and ``kind`` one of ``reference``
(an architecture's plain reference and input draw), ``counts`` (its model
operations), ``kernels`` (a port kernel's wrapper sites, record, counters
and device names) and ``metrics`` (a per-layer metric's reader).  A cell's
configuration, traffic mix and limits are data files found the same way
by :mod:`portbench.harness`.

Imports nothing of the port."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent


def load(kind: str, name: str, here: Path = HERE) -> ModuleType:
    """The module of ``<here>/<kind>/<name>.py``, executed once per file
    and kept in ``sys.modules`` under ``portbench.<kind>:<path>`` (a
    dataclass needs its module there)."""
    path = (here / kind / f"{name}.py").resolve()
    key = f"portbench.{kind}:{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def kernels(here: Path = HERE) -> Dict[str, ModuleType]:
    """Every kernel file of ``here`` by its name, in name order.  A kernel
    file holds ``WRAPS`` (the ``(module, attribute)`` sites through which
    the port calls it), ``record(result, *args, **kwargs)`` (the tuple one
    call leaves in the record, under the file's name), ``COUNTERS``
    (``{name: (module, attribute)}``, a function whose ``.launches`` counts
    its launches), ``CLASS`` and ``DEVICE_NAMES`` (the substrings of the
    device names of its launches)."""
    return {p.stem: load("kernels", p.stem, here)
            for p in sorted((here / "kernels").glob("*.py"))}
