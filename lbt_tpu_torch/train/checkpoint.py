"""Checkpoint save / restore (PyTorch port of
``lbt_tpu/train/checkpoint.py``, Orbax replaced by ``torch.save``).

A checkpoint is the full training state the Trainer resumes from exactly:
``{'model': net.state_dict()`` (every parameter, every exponent buffer
``exp_<site>``, the BN running ``mean`` / ``var``), ``'velocity'``,
``'epoch'``, ``'step'}``.  Layout: ``<directory>/<step>/state.pt``, the
newest ``max_to_keep`` steps kept.  The file is written under a
temporary name, flushed to disk and renamed into place, so a process
killed during a save never leaves a broken latest checkpoint: a step
directory without ``state.pt`` is not a checkpoint.  Loads take tensors
only (``weights_only=True``) onto the template's device, so a checkpoint
written on the card restores on the CPU and the other way round.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"


def _steps(directory: str) -> List[int]:
    """Steps with a complete checkpoint under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit()
                  and os.path.isfile(os.path.join(directory, d, STATE_FILE)))


def save_checkpoint(directory: str, step: int, state: Dict[str, Any],
                    max_to_keep: int = 3) -> None:
    """Write ``state`` as the checkpoint of ``step`` (replacing one of the
    same step), then drop all but the newest ``max_to_keep``."""
    step_dir = os.path.join(directory, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, STATE_FILE)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _device_of(template) -> torch.device:
    if isinstance(template, torch.Tensor):
        return template.device
    if isinstance(template, dict):
        for v in template.values():
            d = _device_of(v)
            if d is not None:
                return d
    return None


def _check(path: str, got, want) -> None:
    """Raise ``ValueError`` where ``got`` does not have ``want``'s keys,
    tensor shapes and dtypes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint {path or '/'}: keys differ: "
                             f"missing {sorted(set(want) - set(got or ()))}, "
                             f"unexpected {sorted(set(got or ()) - set(want))}")
        for k in want:
            _check(f"{path}/{k}", got[k], want[k])
    elif isinstance(want, torch.Tensor):
        if (not isinstance(got, torch.Tensor) or got.shape != want.shape
                or got.dtype != want.dtype):
            raise ValueError(f"checkpoint {path}: {got!r:.60} does not match "
                             f"{tuple(want.shape)} {want.dtype}")


def restore_checkpoint(directory: str, template: Dict[str, Any],
                       step: Optional[int] = None) -> Dict[str, Any]:
    """The checkpoint of ``step`` (default the latest) with the structure,
    shapes and dtypes of ``template``, its tensors on the device of the
    template's tensors."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    state = torch.load(os.path.join(directory, str(int(step)), STATE_FILE),
                       map_location=_device_of(template) or "cpu",
                       weights_only=True)
    _check("", state, template)
    return state
