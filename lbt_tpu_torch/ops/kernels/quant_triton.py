"""Triton source of K1 (see ``quant.py`` for what it replaces and why).

Imported only by :func:`lbt_tpu_torch.ops.kernels.quant.quantize_codes`
when it launches on a CUDA tensor: importing this module needs ``triton``.
Triton compiles the kernel at its first launch for each (bits, mode,
output dtype), into ``lbt_tpu_torch/_build/triton`` unless
``TRITON_CACHE_DIR`` says otherwise.
"""

from __future__ import annotations

from lbt_tpu_torch.ops.kernels import build

build.use_triton_cache_dir()

import triton  # noqa: E402
import triton.language as tl  # noqa: E402
from triton.language.extra import libdevice  # noqa: E402

BLOCK = 4096
NUM_WARPS = 8


@triton.jit
def _quant_kernel(x_ptr, mult_ptr, out_ptr, n, seed,
                  LIMIT: tl.constexpr, STOCHASTIC: tl.constexpr,
                  LIGHT: tl.constexpr, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    scaled = x * tl.load(mult_ptr)
    if STOCHASTIC:
        # lbt_tpu's uint32 counter hash, in int64 lanes masked to 32 bits
        h = offs ^ seed
        if not LIGHT:
            h = h ^ (h >> 16)
        h = (h * 0x7FEB352D) & 0xFFFFFFFF
        h = h ^ (h >> 15)
        h = (h * 0x846CA68B) & 0xFFFFFFFF
        if not LIGHT:
            h = h ^ (h >> 16)
        u = (h >> 8).to(tl.float32) * 5.9604644775390625e-08  # 2**-24
        codes = tl.floor(
            tl.minimum(tl.maximum(scaled + u, -LIMIT), LIMIT - 1.0))
    else:
        codes = libdevice.rint(
            tl.minimum(tl.maximum(scaled, -LIMIT), LIMIT - 1.0))
    tl.store(out_ptr + offs, codes.to(out_ptr.dtype.element_ty), mask=mask)


def launch(x, mult, out, bits: int, seed, light: bool) -> None:
    """Quantize ``x`` into ``out`` on ``x``'s current CUDA stream."""
    n = x.numel()
    stochastic = seed is not None
    _quant_kernel[(triton.cdiv(n, BLOCK),)](
        x, mult, out, n, (seed & 0xFFFFFFFF) if stochastic else 0,
        LIMIT=float(2 ** (bits - 1)), STOCHASTIC=stochastic,
        LIGHT=bool(light), BLOCK=BLOCK, num_warps=NUM_WARPS)
