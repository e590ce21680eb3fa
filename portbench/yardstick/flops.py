"""The H100's peaks, by the precision a configuration contracts in.

A training sample's model operations, which ``mfu.train`` sets against
these, are counted for each architecture by its own count file
(``portbench/counts/<architecture>.py``)."""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense (no sparsity), at its 700 W limit
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}
# the precision each engine contracts in
ENGINE_PEAK = {"int8": "int8", "sim_bf16": "bf16"}


def peak_ops_per_s(spec) -> float:
    """The peak of the precision that ``spec.quant["engine"]`` contracts
    in."""
    return PEAK_OPS_PER_S[ENGINE_PEAK[spec.quant["engine"]]]
