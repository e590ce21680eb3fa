"""DFXP shared-exponent gradient all-reduce with error feedback (PyTorch
port of ``lbt_tpu/parallel/lowbit.py``).

For each gradient leaf, on every rank:

1. ``total = grad + buffer`` (error feedback);
2. the ranks agree on a power-of-two scale: one MAX all-reduce of the
   local ``max |total|``, then ``e`` the ``frexp`` exponent of it;
3. ``codes = round(total * 2**(bits-1-e))`` (half to even), clipped to
   ``±(2**(bits-1) - 1)``;
4. the codes are summed over the ranks, then divided by the multiplier
   (and by N for ``reduce='mean'``);
5. the local residual ``total - codes / mult`` is the next buffer.

The leaves travel together: one MAX all-reduce of every leaf's maximum,
then one bucket of every leaf's codes.  Sums and maxima are exact, so
this equals ``lbt_tpu``'s per-leaf collectives bit for bit.  Under tensor
parallelism (``tp``, the model group) a rank holds column slices of the
sharded leaves, and the maxima are first taken over the model group, so
the shared exponent is the whole leaf's, as ``lbt_tpu``'s ``max |total|``
of a leaf sharded over ``'model'`` is; the codes and residuals are the
slice's own, summed over the data group.

Transports:

* :func:`lowbit_allreduce` sums the codes with one SUM all-reduce of
  **int32** codes.  ``lbt_tpu`` sends int16 when ``2**(bits-1) * N <
  2**15``; the sum is exact in either width, so the result is the same
  bits, but neither gloo nor NCCL reduces int16.  The wire carries 4
  bytes an element where ``lbt_tpu``'s carries 2 (its int32 fallback:
  4), against f32's 4: the psum transport saves no bytes here, only the
  exactness of the integer sum.
* :func:`ring_lowbit_allreduce` runs the ring itself: the bucket is cut
  in N chunks, reduce-scattered and then all-gathered over ``N - 1``
  hops each, each hop one ``isend`` to the next rank and one ``irecv``
  from the previous (``Group.ring_pass``, raw bytes, so int16 passes
  either backend).  No collective reduces anything: the additions run
  here in the wire dtype, as ``lbt_tpu``'s ``ppermute`` ring adds.
  ``wire='int16'`` is exact (``2**(bits-1) * N < 2**15``) and equals the
  psum transport; ``wire='int8'`` widens every leaf's exponent by
  ``ceil(log2 N)`` so the partial sums stay near int8, 1 byte an element
  each way.  A partial sum that reaches ±128 wraps, in int8 two's
  complement, in both packages.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from lbt_tpu_torch.ops.kernels.quant import multiplier

__all__ = ["init_error_buffers", "lowbit_allreduce",
           "ring_lowbit_allreduce"]

Tensors = Dict[str, torch.Tensor]


def init_error_buffers(params) -> Tensors:
    """Zero error-feedback buffers, one a parameter."""
    return {k: torch.zeros_like(p, requires_grad=False)
            for k, p in params.items()}


def _quantize(grads: Tensors, buffers: Tensors, group, bits: int,
              extra: int, tp=None):
    """``(codes, mults, residuals)`` of every leaf, at the exponents the
    ranks agree on (one MAX all-reduce of the stacked local maxima, over
    the model group ``tp`` first)."""
    totals = {k: g + buffers[k] for k, g in grads.items()}
    local = torch.stack([t.abs().max() for t in totals.values()])
    if tp is not None:
        local = tp.all_reduce(local, "max", kind="stats")
    gmax = group.all_reduce(local, "max")
    e = torch.frexp(torch.clamp(gmax, min=1e-30))[1].to(torch.int32) + extra
    limit = float(2 ** (bits - 1))
    codes, mults, residuals = {}, {}, {}
    for i, (k, total) in enumerate(totals.items()):
        mult = multiplier(bits, e[i], total.device)
        c = torch.clamp(torch.round(total * mult), -(limit - 1), limit - 1)
        codes[k], mults[k] = c, mult
        residuals[k] = total - c / mult
    return codes, mults, residuals


def _unflatten(summed: torch.Tensor, grads: Tensors, mults: Tensors,
               scale: float) -> Tensors:
    out, off = {}, 0
    for k, g in grads.items():
        n = g.numel()
        v = summed[off:off + n].view(g.shape) / mults[k]
        out[k] = v * scale if scale != 1.0 else v
        off += n
    return out


def lowbit_allreduce(grads: Tensors, buffers: Tensors, group,
                     bits: int = 8, reduce: str = "sum", tp=None
                     ) -> Tuple[Tensors, Tensors]:
    """``(reduced grads, new error buffers)`` over ``group`` (a
    :class:`~lbt_tpu_torch.parallel.multihost.Group`), the codes summed
    by one int32 SUM all-reduce.  ``reduce='sum'`` fits the DP step's
    1/N loss scaling; ``'mean'`` divides by N.  ``tp`` is the model group
    of a tensor-parallel layout (the leaves' maxima over it first)."""
    codes, mults, residuals = _quantize(grads, buffers, group, bits, 0, tp)
    flat = torch.cat([c.reshape(-1) for c in codes.values()]).to(torch.int32)
    summed = group.all_reduce(flat).to(torch.float32)
    out = _unflatten(summed, grads, mults, 1.0)
    if reduce == "mean":
        out = {k: v / float(group.world) for k, v in out.items()}
    return out, residuals


def ring_lowbit_allreduce(grads: Tensors, buffers: Tensors, group,
                          bits: int = 8, wire: str = "int16",
                          reduce: str = "sum", tp=None
                          ) -> Tuple[Tensors, Tensors]:
    """The low-bit all-reduce as an explicit ring over one flat bucket of
    every leaf's codes, in the ``wire`` dtype (``'int16'`` exact,
    ``'int8'`` with each exponent widened by ``ceil(log2 N)``).  Each of
    the ``2 (N - 1)`` hops moves ``bucket / N`` elements of ``wire``.
    ``tp`` as in :func:`lowbit_allreduce`."""
    n = group.world
    if wire == "int8":
        if bits > 8:
            raise ValueError("the int8 wire needs bits <= 8")
        wire_dt = torch.int8
        extra = int(math.ceil(math.log2(n))) if n > 1 else 0
    elif wire == "int16":
        if 2 ** (bits - 1) * n >= 2 ** 15:
            raise ValueError("the int16 wire's partial sums are exact only "
                             "for 2^(bits-1) * N < 2^15")
        wire_dt = torch.int16
        extra = 0
    else:
        raise ValueError(f"unknown wire {wire!r}")
    codes, mults, residuals = _quantize(grads, buffers, group, bits, extra,
                                        tp)
    flat = torch.cat([c.reshape(-1) for c in codes.values()])
    size = flat.numel()
    csize = -(-size // n)
    chunks = torch.zeros(n * csize, dtype=wire_dt, device=flat.device)
    chunks[:size] = flat.to(wire_dt)
    chunks = chunks.view(n, csize)
    if n > 1:
        i = group.rank
        # reduce-scatter: after n - 1 hops rank i owns chunk (i + 1) % n
        send = chunks[i]
        for t in range(n - 1):
            send = group.ring_pass(send) + chunks[(i - 1 - t) % n]
        # all-gather the owned chunks into the whole bucket
        out = torch.empty_like(chunks)
        out[(i + 1) % n] = send
        cur = send
        for t in range(n - 1):
            cur = group.ring_pass(cur)
            out[(i - t) % n] = cur
        summed = out.reshape(-1)[:size].to(torch.float32)
    else:
        summed = chunks.reshape(-1)[:size].to(torch.float32)
    out = _unflatten(summed, grads, mults, 1.0 / n if reduce == "mean"
                     else 1.0)
    return out, residuals
