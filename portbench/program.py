"""The system under test: ``lbt_tpu_torch``'s ``Trainer`` built from a
configuration file, its weights loaded from the benchmark's seeded ones,
and what the benchmark reads of it: the losses a step returns, its state,
the kernels' call shapes and launch counters.

Imported only after the harness has checked for the card, and never by
``portbench/reference``."""

from __future__ import annotations

import collections
import contextlib
import logging
from typing import Dict, List
from unittest import mock

import torch

import lbt_tpu_torch
from lbt_tpu_torch.config import QuantConfig, TrainConfig
from lbt_tpu_torch.dfxp import quantize as qmod
from lbt_tpu_torch.models import build_model
from lbt_tpu_torch.ops import qops
from lbt_tpu_torch.ops.kernels import conv_fused, gemm, quant
from lbt_tpu_torch.train.trainer import Trainer

PACKAGE_FILE = lbt_tpu_torch.__file__


def _quiet_logger() -> logging.Logger:
    log = logging.getLogger("portbench.program")
    log.setLevel(logging.WARNING)
    log.propagate = False
    if not log.handlers:
        log.addHandler(logging.NullHandler())
    return log


class Program:
    """One ``Trainer`` on ``device`` under the configuration ``cfg`` (a
    configuration file's dict), batches of ``batch_size``, the stochastic
    rounding keyed by ``key_seed``, starting at ``start_step``."""

    def __init__(self, cfg: Dict, batch_size: int, key_seed: int,
                 start_step: int, device):
        m, t = cfg["model"], cfg["train"]
        self.qc = QuantConfig(**cfg["quant"])
        model = build_model(m["zoo"], self.qc, num_classes=m["num_classes"],
                            image_size=m["image_size"],
                            weight_decay=t["weight_decay"])
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


def counters() -> Dict[str, int]:
    """The kernel wrappers' launch counters."""
    return {"k1": quant.quantize_codes.launches,
            "k2": gemm.int8_matmul.launches,
            "k2_tn": gemm.int8_matmul_tn.launches,
            "conv3x3": conv_fused.conv3x3_fused.launches,
            "conv1x1": conv_fused.conv1x1_fused.launches}


@contextlib.contextmanager
def recorded_calls():
    """While open, every call of K1, K2 (both forms) and #4/#5 is recorded
    with what the yardstick needs (shapes, code widths, noise mode,
    statistics) in the dict it yields."""
    calls = collections.defaultdict(list)

    def k1(x, bits, exp, noise=None, stats=False):
        out = quant.quantize_codes(x, bits, exp, noise, stats)
        calls["k1"].append((x.numel(), out[0].element_size(), bool(stats),
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
        def rec(xc, wc, inv, mult, *, strides, pads, bits_out=8, noise=None,
                round_bf16=False):
            calls["conv"].append((tuple(xc.shape), xc.element_size(),
                                  tuple(wc.shape), tuple(strides),
                                  tuple(map(tuple, pads)),
                                  0 if noise is None else noise.mode))
            return fn(xc, wc, inv, mult, strides=strides, pads=pads,
                      bits_out=bits_out, noise=noise, round_bf16=round_bf16)
        return rec

    with mock.patch.object(qmod, "quantize_codes", k1), \
            mock.patch.object(qops, "int8_matmul", k2), \
            mock.patch.object(qops, "int8_matmul_tn", k2_tn), \
            mock.patch.object(qops, "conv3x3_fused",
                              fused(conv_fused.conv3x3_fused)), \
            mock.patch.object(qops, "conv1x1_fused",
                              fused(conv_fused.conv1x1_fused)):
        yield calls
