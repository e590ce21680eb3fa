"""Convolution geometry on NHWC integer codes: TF-style padding, output
sizes, im2col, and the lhs dilation of a cotangent for the input
gradient (``lbt_tpu/ops/qops.py``, ``conv_pads`` and
``_dx_conv_params``).  Plain PyTorch; the contractions that follow are
kernels."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Pads = Tuple[Tuple[int, int], ...]


def conv_same_padding(in_size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF-style 'SAME' padding (lo, hi) for one spatial dim."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + k - in_size, 0)
    lo = total // 2
    return lo, total - lo


def conv_pads(padding, in_sizes: Sequence[int], ks: Sequence[int],
              strides: Sequence[int]) -> Pads:
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return tuple(conv_same_padding(i, k, s)
                         for i, k, s in zip(in_sizes, ks, strides))
        if padding.upper() == "VALID":
            return tuple((0, 0) for _ in in_sizes)
        raise ValueError(f"bad padding {padding!r}")
    return tuple(tuple(p) for p in padding)


def out_hw(h: int, w: int, ksize, strides, pads: Pads) -> Tuple[int, int]:
    return ((h + sum(pads[0]) - ksize[0]) // strides[0] + 1,
            (w + sum(pads[1]) - ksize[1]) // strides[1] + 1)


def im2col(codes: torch.Tensor, ksize: Tuple[int, int],
           strides: Tuple[int, int], pads: Pads) -> torch.Tensor:
    """NHWC codes -> ``[B*Ho*Wo, kh*kw*C]`` patches, columns ordered
    ``(i, j, c)`` to match an HWIO kernel flattened to ``[kh*kw*C, Cout]``.
    Padding positions hold zero codes."""
    b, h, w, c = codes.shape
    (kh, kw), (sh, sw) = ksize, strides
    (plo, phi), (qlo, qhi) = pads
    ho, wo = out_hw(h, w, ksize, strides, pads)
    if plo or phi or qlo or qhi:
        xp = codes.new_zeros((b, h + plo + phi, w + qlo + qhi, c))
        xp[:, plo:plo + h, qlo:qlo + w] = codes
    else:
        xp = codes
    taps = [xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c)


def dx_pads(x_hw, k_hw, strides, pads, y_hw) -> Pads:
    """Padding of the lhs-dilated cotangent for the input-gradient conv:
    ``(y-1)*s + 1 + lo' + hi' - k + 1 == x`` per dim (may be negative)."""
    return tuple((k - 1 - lo, x + lo - 1 - (y - 1) * s)
                 for x, k, s, (lo, _hi), y in zip(x_hw, k_hw, strides, pads,
                                                  y_hw))


def dilate_pad(g: torch.Tensor, strides, pads: Pads) -> torch.Tensor:
    """NHWC ``g`` with ``s-1`` zeros between neighbours along H and W and
    ``pads`` zeros around them; a negative pad crops."""
    b, h, w, c = g.shape
    (sh, sw), ((plo, phi), (qlo, qhi)) = strides, pads
    dh, dw = (h - 1) * sh + 1, (w - 1) * sw + 1
    # place the dilated grid at (max(lo,0), ...) in a buffer padded by the
    # non-negative part, then crop the negative part
    out = g.new_zeros((b, dh + max(plo, 0) + max(phi, 0),
                       dw + max(qlo, 0) + max(qhi, 0), c))
    out[:, max(plo, 0):max(plo, 0) + dh:sh,
        max(qlo, 0):max(qlo, 0) + dw:sw] = g
    return out[:, max(-plo, 0):out.shape[1] - max(-phi, 0),
               max(-qlo, 0):out.shape[2] - max(-qhi, 0)]
