"""Model operations of a ResNet training step and the H100's peaks.

The count is the contractions the step needs, from the layer shapes of the
reference's architecture (``portbench/reference/resnet.py``): a
multiply-add is 2 operations; a training image costs its forward
contractions, and in the backward the input gradient (dx) and the weight
gradient (dW) of each, but for the stem's dx, which no step needs (the
images take no gradient): ``2 * (3 * forward_macs - stem_macs)``.  No
recomputation, no elementwise work and no quantizer is counted.

He et al. 2015 (arXiv:1512.03385, Table 1) give ResNet-50 as 3.8e9
"FLOPs" (multiply-adds) at 224 px.  The zoo's bottleneck strides its 3x3
conv (as torchvision's ResNet-50 does, "v1.5"), where the paper strides
the first 1x1: the 3x3 then runs at the higher resolution, which makes
4.089e9 multiply-adds an image here (:func:`forward_macs`); the paper's
placement gives 3.86e9.
"""

from __future__ import annotations

from typing import Tuple

from portbench.reference.resnet import Node, Spec, build

# NVIDIA's H100 SXM data sheet, dense (no sparsity), at its 700 W limit
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}
# the precision each engine contracts in
ENGINE_PEAK = {"int8": "int8", "sim_bf16": "bf16"}


def _walk(n: Node, hw: Tuple[int, int]):
    """``(multiply-adds of n's contractions per image, hw out)``."""
    k = n.kind
    if k == "conv":
        kh, kw, cin, cout = n.args["ksize"]
        s = n.args["strides"][0]
        out = (-(-hw[0] // s), -(-hw[1] // s))
        return out[0] * out[1] * kh * kw * cin * cout, out
    if k == "dense":
        return n.args["cin"] * n.args["cout"], hw
    if k == "maxpool":
        return 0, (-(-hw[0] // 2), -(-hw[1] // 2))
    if k == "avgpool":
        return 0, (1, 1)
    if k == "block":
        macs, out = _walk(n.children[0], hw)
        return macs + _walk(n.children[1], hw)[0], out
    macs = 0
    for c in n.children:
        m, hw = _walk(c, hw)
        macs += m
    return macs, hw


def forward_macs(spec: Spec) -> Tuple[int, int]:
    """``(multiply-adds of one image's forward, the stem conv's share)``."""
    root, _ = build(spec)
    stem = root.children[0]
    hw = (spec.image_size, spec.image_size)
    return _walk(root, hw)[0], _walk(stem, hw)[0]


def train_ops_per_image(spec: Spec) -> int:
    fwd, stem = forward_macs(spec)
    return 2 * (3 * fwd - stem)


def peak_ops_per_s(spec: Spec) -> float:
    return PEAK_OPS_PER_S[ENGINE_PEAK[spec.quant["engine"]]]
