"""Configuration for the PyTorch port.

``QuantConfig`` and ``TrainConfig`` are the port's own frozen dataclasses
with ``lbt_tpu.config``'s fields, defaults, validation and constructors
(a test holds them equal), so the port imports nothing of ``lbt_tpu``.
The JAX-typed ``QuantConfig.carrier_dtype`` property has no counterpart:
:func:`carrier_dtype` gives the torch dtype.  Field comments are short;
``lbt_tpu/config.py`` documents each knob in full.

The port runs every engine: ``'int8'`` (the hand-written kernels),
``'pallas'`` as an alias of the same route (its stochastic noise is the
stream of ``noise_mode``, not a TPU hardware stream), and the float
simulation ``'sim'`` / ``'sim_bf16'``, under either key
(``noise_impl``): ``'threefry2x32'`` or ``'unsafe_rbg'``, whose ``prng``
noise is XLA's Philox stream (``dfxp/keys.py``).  Every option of
``lbt_tpu``'s configuration runs (``remat_bn`` and ``bn_residual_q16``:
``nn/norm.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["INT_ENGINES", "QuantConfig", "TrainConfig", "carrier_dtype"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """DFXP quantization scheme for one model; ``bits == 32`` is an exact
    passthrough for that tensor class."""

    bits_w: int = 8        # weights
    bits_a: int = 8        # activations (dense); conv acts get +conv_act_extra
    bits_b: int = 8        # biases / BN beta, gamma
    bits_g: int = 8        # backward cotangents
    conv_act_extra: int = 1  # conv activations quantized at bits_a + this
    target_overflow_rate: float = 0.0
    initial_exponent: int = 2
    initial_exponent_g: Optional[int] = None  # cold-start exp of grad sites
    stochastic: bool = True
    noise_shared_axis0: bool = False
    noise_impl: str = "threefry2x32"
    noise_mode: str = "prng"   # 'prng' | 'hash' | 'hash1'
    engine: str = "int8"       # 'sim' | 'sim_bf16' | 'int8' | 'pallas'
    bn_momentum: float = 0.999
    fused_bn: bool = False
    faithful_eval: bool = False
    act_dtype: str = "f32"
    remat_bn: bool = False
    bn_residual_q16: bool = False
    conv9_split: bool = False  # the port's 9-bit convs are split-9 always
    range_update_every: int = 1
    stem_s2d: bool = False
    range_update_warmup_steps: int = 200

    def __post_init__(self):
        for name in ("bits_w", "bits_a", "bits_b", "bits_g"):
            b = getattr(self, name)
            if not (1 <= b <= 32):
                raise ValueError(f"invalid {name}={b}, expected 1..32")
        if self.engine not in ("sim", "sim_bf16", "int8", "pallas"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.noise_impl not in ("threefry2x32", "unsafe_rbg"):
            raise ValueError(f"unknown noise_impl {self.noise_impl!r}")
        if self.noise_mode not in ("prng", "hash", "hash1"):
            raise ValueError(f"unknown noise_mode {self.noise_mode!r}")
        if self.range_update_every < 1:
            raise ValueError("range_update_every must be >= 1")
        if self.act_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown act_dtype {self.act_dtype!r}")
        if self.initial_exponent_g is not None and not (
                -64 <= self.initial_exponent_g <= 31):
            raise ValueError(
                f"initial_exponent_g={self.initial_exponent_g} out of range")

    @property
    def bits_a_conv(self) -> int:
        return min(self.bits_a + self.conv_act_extra, 32)

    @property
    def resolved_noise_bits(self) -> int:
        return 24

    @property
    def quant_backend(self) -> str:
        """Noise backend of the quantize sites (see ``quantize_int``)."""
        return {"hash": "xla_hash", "hash1": "xla_hash1",
                "prng": "xla"}[self.noise_mode]

    @classmethod
    def fp32(cls, **kw) -> "QuantConfig":
        base = dict(bits_w=32, bits_a=32, bits_b=32, bits_g=32,
                    conv_act_extra=0, stochastic=False, engine="sim")
        base.update(kw)
        return cls(**base)

    @classmethod
    def uniform(cls, bits: int, **kw) -> "QuantConfig":
        """Reference-style single bit-width (conv acts at bits+1)."""
        if bits == 32:
            return cls.fp32(**kw)
        return cls(bits_w=bits, bits_a=bits, bits_b=bits, bits_g=bits, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe; defaults are the reference CLI's."""

    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 2e-4
    batch_size: int = 32
    n_epoch: int = 160
    lr_decay_factor: float = 0.1
    lr_decay_epochs: Tuple[int, ...] = (80, 120, 140)
    warmup_epochs: int = 0
    dropout_keep: float = 0.5
    reset_momentum_on_decay: bool = False
    eval_batch_size: int = 1000
    log_every: int = 100
    seed: int = 0
    checkpoint_every_epochs: int = 10
    checkpoint_dir: Optional[str] = None
    data_parallel: bool = False
    tensor_parallel: int = 1
    lowbit_allreduce: bool = False
    lowbit_wire: Optional[str] = None
    scan_steps: int = 0


# engines whose contractions run on integer codes through the kernels
INT_ENGINES = ("int8", "pallas")

def carrier_dtype(cfg: QuantConfig) -> torch.dtype:
    """torch dtype of inter-layer activations (``QuantConfig.act_dtype``):
    every quantized layer computes in f32 and casts its output to this."""
    return torch.bfloat16 if cfg.act_dtype == "bf16" else torch.float32
