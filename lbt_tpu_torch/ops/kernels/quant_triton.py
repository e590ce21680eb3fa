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
def _quant_kernel(x_ptr, mult_ptr, out_ptr, part_ptr, n, seed,
                  LIMIT: tl.constexpr, STOCHASTIC: tl.constexpr,
                  LIGHT: tl.constexpr, STATS: tl.constexpr,
                  BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    scaled = x * tl.load(mult_ptr)
    if STATS:
        # this block's min / max of the scaled tensor; _minmax_kernel
        # reduces the per-block pairs (min / max are exact in any order)
        tl.store(part_ptr + 2 * pid,
                 tl.min(tl.where(mask, scaled, float("inf")), axis=0))
        tl.store(part_ptr + 2 * pid + 1,
                 tl.max(tl.where(mask, scaled, -float("inf")), axis=0))
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


@triton.jit
def _minmax_kernel(part_ptr, out_ptr, nparts, BLOCK: tl.constexpr):
    lo = tl.full([BLOCK], float("inf"), tl.float32)
    hi = tl.full([BLOCK], -float("inf"), tl.float32)
    for start in range(0, nparts, BLOCK):
        offs = start + tl.arange(0, BLOCK)
        m = offs < nparts
        lo = tl.minimum(lo, tl.load(part_ptr + 2 * offs, mask=m,
                                    other=float("inf")))
        hi = tl.maximum(hi, tl.load(part_ptr + 2 * offs + 1, mask=m,
                                    other=-float("inf")))
    tl.store(out_ptr, tl.min(lo, axis=0))
    tl.store(out_ptr + 1, tl.max(hi, axis=0))


def launch(x, mult, out, bits: int, seed, light: bool,
           minmax=None) -> None:
    """Quantize ``x`` into ``out`` on ``x``'s current CUDA stream; with
    ``minmax`` (two f32 on the device) also write ``[min, max]`` of
    ``x * mult`` there."""
    n = x.numel()
    stochastic = seed is not None
    grid = triton.cdiv(n, BLOCK)
    part = (x.new_empty((grid, 2), dtype=x.dtype) if minmax is not None
            else x)
    _quant_kernel[(grid,)](
        x, mult, out, part, n, (seed & 0xFFFFFFFF) if stochastic else 0,
        LIMIT=float(2 ** (bits - 1)), STOCHASTIC=stochastic,
        LIGHT=bool(light), STATS=minmax is not None, BLOCK=BLOCK,
        num_warps=NUM_WARPS)
    if minmax is not None:
        _minmax_kernel[(1,)](part, minmax, grid, BLOCK=1024, num_warps=4)
