"""The system under test: ``lbt_tpu_torch``'s ``Trainer`` built from a
configuration file, its weights loaded from the benchmark's seeded ones,
and what the benchmark reads of it: the losses a step returns, its state,
the call shapes and launch counters of the kernels that
``portbench/kernels/`` names.

Imported only after the harness has checked for the card, and never by
``portbench/reference``."""

from __future__ import annotations

import collections
import contextlib
import importlib
import logging
from pathlib import Path
from typing import Dict, List
from unittest import mock

import torch

import lbt_tpu_torch
from lbt_tpu_torch.config import QuantConfig, TrainConfig
from lbt_tpu_torch.models import build_model
from lbt_tpu_torch.train.trainer import Trainer
from portbench import by_name

PACKAGE_FILE = lbt_tpu_torch.__file__


def _quiet_logger() -> logging.Logger:
    log = logging.getLogger("portbench.program")
    log.setLevel(logging.WARNING)
    log.propagate = False
    if not log.handlers:
        log.addHandler(logging.NullHandler())
    return log


def build_kwargs(cfg: Dict) -> Dict:
    """The zoo builder's keyword arguments that ``cfg`` lists
    (``architecture.build``: dotted paths into the configuration, each
    passed under its last name)."""
    out = {}
    for path in cfg["architecture"]["build"]:
        v = cfg
        for part in path.split("."):
            v = v[part]
        out[path.rsplit(".", 1)[-1]] = v
    return out


class Program:
    """One ``Trainer`` on ``device`` under the configuration ``cfg`` (a
    configuration file's dict), batches of ``batch_size``, the stochastic
    rounding keyed by ``key_seed``, starting at ``start_step``."""

    def __init__(self, cfg: Dict, batch_size: int, key_seed: int,
                 start_step: int, device):
        t = cfg["train"]
        self.qc = QuantConfig(**cfg["quant"])
        model = build_model(cfg["model"]["zoo"], self.qc,
                            **build_kwargs(cfg))
        tc = TrainConfig(lr=t["lr"], momentum=t["momentum"],
                         weight_decay=t["weight_decay"],
                         batch_size=batch_size, seed=key_seed,
                         log_every=2 ** 62)
        self._source = iter(())
        self.trainer = Trainer(
            model, tc, {"train_iter": lambda epoch, bs: self._source},
            logger=_quiet_logger(), device=device)
        self.trainer.step = start_step
        self.model = model

    def load(self, params: Dict[str, torch.Tensor]) -> None:
        """The benchmark's initial weights in place of the Trainer's."""
        own = dict(self.model.net.named_parameters())
        if list(own) != list(params) or any(
                own[k].shape != params[k].shape for k in own):
            raise ValueError("the reference's leaves are not the model's")
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(params[k])

    def run(self, batches) -> Dict[str, float]:
        """One ``train_epoch`` over ``batches`` (host ``(x, y)`` pairs):
        the epoch's wall seconds, images and input-stall seconds."""
        self._source = iter(batches)
        self.trainer.train_epoch(0)
        return dict(self.trainer.epoch_time)

    @contextlib.contextmanager
    def losses(self):
        """While open, each train step's loss (a device tensor) is
        appended to the list it yields."""
        out: List[torch.Tensor] = []
        step = self.trainer.train_step

        def recorded(*a, **kw):
            m = step(*a, **kw)
            out.append(m["loss"])
            return m

        self.trainer.train_step = recorded
        try:
            yield out
        finally:
            self.trainer.train_step = step

    # -- state --------------------------------------------------------------
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.net.named_parameters())

    def velocity(self) -> Dict[str, torch.Tensor]:
        return self.trainer.velocity

    def bn_stats(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.model.net.state_dict().items()
                if k.endswith(".mean") or k.endswith(".var")}

    def exponents(self) -> Dict[str, int]:
        sd = self.model.net.state_dict()
        names = [k for k in sd if k.rsplit(".", 1)[-1].startswith("exp_")]
        vals = torch.stack([sd[k].reshape(()) for k in names]).cpu().tolist()
        return dict(zip(names, vals))


# -- the kernels' calls and counters ------------------------------------------


def counters(here: Path = by_name.HERE) -> Dict[str, int]:
    """The launch counters of ``here``'s kernel files."""
    return {name: getattr(importlib.import_module(module), fn).launches
            for k in by_name.kernels(here).values()
            for name, (module, fn) in k.COUNTERS.items()}


def _recording(fn, record, calls: Dict[str, List], key: str):
    def rec(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls[key].append(record(out, *args, **kwargs))
        return out
    return rec


@contextlib.contextmanager
def recorded_calls(here: Path = by_name.HERE):
    """While open, every call of a kernel of ``here``'s kernel files
    through one of its sites is recorded as its file's ``record`` gives it
    (shapes, code widths, noise mode, statistics: what the yardstick
    needs), under the file's name, in the dict it yields."""
    calls = collections.defaultdict(list)
    with contextlib.ExitStack() as stack:
        for key, k in by_name.kernels(here).items():
            for module, name in k.WRAPS:
                mod = importlib.import_module(module)
                stack.enter_context(mock.patch.object(
                    mod, name, _recording(getattr(mod, name), k.record,
                                          calls, key)))
        yield calls
