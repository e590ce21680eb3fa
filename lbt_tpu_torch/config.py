"""Configuration for the PyTorch port.

``QuantConfig`` and ``TrainConfig`` are ``lbt_tpu``'s own dataclasses,
re-exported unchanged: ``lbt_tpu.config`` imports no JAX at module scope.
Never read ``QuantConfig.carrier_dtype`` here — it imports JAX lazily;
:func:`carrier_dtype` is the port's counterpart.

The port runs the integer engine only: ``engine='int8'``, with
``'pallas'`` accepted as an alias of the same hand-written kernel route.
Options that later ports cover raise ``NotImplementedError`` from
:func:`check_supported` instead of silently running something else.
"""

from __future__ import annotations

import torch

from lbt_tpu.config import QuantConfig, TrainConfig

__all__ = ["QuantConfig", "TrainConfig", "carrier_dtype", "check_supported"]

_ENGINES = ("int8", "pallas")

# QuantConfig flags whose code paths are not ported yet (value != default)
_NOT_PORTED_FLAGS = ("fused_bn", "remat_bn", "bn_residual_q16",
                     "conv9_split", "stem_s2d")


def check_supported(cfg: QuantConfig) -> QuantConfig:
    """Raise ``NotImplementedError`` for a configuration the port cannot
    run yet; return ``cfg`` unchanged otherwise."""
    if cfg.engine not in _ENGINES:
        raise NotImplementedError(
            f"engine {cfg.engine!r} is not ported; the port runs "
            f"{_ENGINES}")
    for flag in _NOT_PORTED_FLAGS:
        if getattr(cfg, flag):
            raise NotImplementedError(f"QuantConfig.{flag} is not ported")
    carrier_dtype(cfg)
    return cfg


def carrier_dtype(cfg: QuantConfig) -> torch.dtype:
    """torch dtype of inter-layer activations (``QuantConfig.act_dtype``)."""
    if cfg.act_dtype != "f32":
        raise NotImplementedError(
            f"act_dtype={cfg.act_dtype!r} is not ported")
    return torch.float32
