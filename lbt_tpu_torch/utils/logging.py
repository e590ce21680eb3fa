"""Experiment logging (PyTorch port of ``lbt_tpu/utils/logging.py``).

A Python logger (stderr plus ``experiment.log``) and a JSONL metrics
stream with a TensorBoard mirror (:mod:`lbt_tpu_torch.utils.tb`).  The
tags are ``lbt_tpu``'s, so one model writes one tag set in both packages:
``train/<metric>``, ``test/<metric>``, ``exp/<layer path>/exp/<site>`` for
every exponent and ``param/<layer path>/<name>_mean`` for every
parameter, the layer path being the layer's keys in ``lbt_tpu``'s trees.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from lbt_tpu_torch.nn.core import layer_paths
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.utils.tb import EventWriter


def get_logger(path: Optional[str] = None,
               name: str = "lbt_tpu_torch") -> logging.Logger:
    """The named logger, writing to stderr and, given ``path``, to that
    file.  A later call with another ``path`` moves the file output there
    (one process may run several experiments)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if path:
        path = os.path.abspath(path)
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def null_logger() -> logging.Logger:
    """A logger that writes nothing: a data-parallel rank other than 0."""
    logger = logging.getLogger("lbt_tpu_torch.rank")
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def _to_scalar(v):
    if isinstance(v, (torch.Tensor, np.ndarray, np.generic)):
        return float(v.item())
    return v


class MetricsWriter:
    """JSONL metrics (``<logdir>/metrics.jsonl``, one line per event) and
    a TensorBoard mirror; writes nothing without a ``logdir``."""

    def __init__(self, logdir: Optional[str]):
        self._f = None
        self._tb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")
            self._tb = EventWriter(logdir)

    def write(self, step: int, metrics: Dict[str, Any], prefix: str = ""):
        if self._f is None:
            return
        row = {f"{prefix}{k}": _to_scalar(v) for k, v in metrics.items()}
        row["step"] = int(step)
        row["time"] = time.time()
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.scalars(step, {
                k: v for k, v in row.items()
                if k not in ("step", "time") and isinstance(v, (int, float))
            })

    def _write_stacked(self, step: int, tags, tensors) -> None:
        """One row of ``tags`` -> the 0-d ``tensors``, read to the host in
        one copy."""
        if tags:
            values = torch.stack(tensors).cpu().tolist()
            self.write(step, dict(zip(tags, values)))

    def write_exponents(self, step: int, model: Model, prefix: str = "exp/"):
        """Every quantizer exponent (the reference's ``*_range`` scalars)."""
        if self._f is None:
            return
        tags, exps = [], []
        for path, layer in layer_paths(model.net):
            for site in layer.exp_sites():
                tags.append(f"{prefix}{path}/exp/{site}")
                exps.append(layer.exp(site).to(torch.float32))
        self._write_stacked(step, tags, exps)

    def write_param_means(self, step: int, model: Model,
                          prefix: str = "param/"):
        """The mean of every parameter (the reference's ``W_mean`` /
        ``b_mean`` / ``g_mean`` scalars).  A tensor-parallel layer's
        ``W`` slice is one part of its weight: its mean is the sum over
        the model group (a collective, so every rank calls this) over the
        whole weight's count."""
        layers = layer_paths(model.net)
        if self._f is None and all(getattr(layer, "shard", None) is None
                                   for _, layer in layers):
            return
        tags, means, parts = [], [], []
        with torch.no_grad():
            for path, layer in layers:
                shard = getattr(layer, "shard", None)
                for k, p in layer.named_parameters(recurse=False):
                    tags.append(f"{prefix}{path}/{k}_mean")
                    p = p.to(torch.float32)
                    if shard is not None and k == "W":
                        parts.append((len(means), shard,
                                      p.numel() // shard.width * shard.n))
                        means.append(p.sum())
                    else:
                        means.append(p.mean())
            if parts:
                group = parts[0][1].group
                sums = group.all_reduce(
                    torch.stack([means[i] for i, _, _ in parts]),
                    kind="metrics")
                for (i, _, n), v in zip(parts, sums):
                    means[i] = v / n
        if self._f is None:
            return
        self._write_stacked(step, tags, means)

    def close(self):
        if self._f:
            self._f.close()
        if self._tb:
            self._tb.close()
