"""Serving (PyTorch port of ``lbt_tpu/infer.py``): a predict function and a
``Predictor`` handle, on the card unless asked for the CPU.

The serving forward runs the model's engine with running BN statistics,
deterministic round-half-even quantization and no state updates
(``Ctx(train=False, update=False)``).  Orbax checkpoints, the int8 weight
export and BN folding are not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from lbt_tpu_torch.convert import from_jax_numpy
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.utils.device import full_f32, resolve_device


def make_predict_fn(model: Model, return_probs: bool = False):
    """``x -> labels [, probs]`` for NHWC f32 ``x`` on the model's device."""
    ctx = Ctx(train=False, update=False)

    @full_f32()
    @torch.inference_mode()
    def predict(x: torch.Tensor):
        logits = model.apply(x, ctx)
        labels = logits.argmax(dim=-1)
        if return_probs:
            return labels, torch.softmax(logits, dim=-1)
        return labels

    return predict


class Predictor:
    """Serving handle.  ``params`` / ``qstate``, when given, are
    ``lbt_tpu``'s trees as numpy arrays and are loaded into ``model``;
    the model then moves to ``device``: the card by default (raising
    without one), the CPU only when ``device="cpu"``.

    >>> p = Predictor(model, params, qstate)
    >>> labels = p(batch)
    """

    def __init__(self, model: Model, params: Optional[Mapping] = None,
                 qstate: Optional[Mapping] = None, *, device=None):
        if (params is None) != (qstate is None):
            raise ValueError("give both params and qstate, or neither")
        if params is not None:
            from_jax_numpy(model, params, qstate)
        model.to(resolve_device(device))
        self.model = model
        self.device = model.device
        self._fn = make_predict_fn(model)

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return self._fn(x.contiguous())
