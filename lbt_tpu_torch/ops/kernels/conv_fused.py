"""Kernels #4 and #5: an int8 conv fused with the DFXP epilogue of the BN
input site that follows it.

Replace ``conv3x3_fused_int8`` (``lbt_tpu/ops/pallas/conv_kernels.py``)
and ``conv1x1_fused_int8`` (``lbt_tpu/ops/pallas/conv1x1_kernels.py``).
From a conv's input codes and weight codes they return the codes of the
conv output quantized at the next site, the per-channel sum and sum of
squares of those codes, and the min / max of the f32 conv output, which
never reaches device memory.  The kernels are CUDA C++ in
``lbt_tpu_torch/csrc/conv_fused.cuh``, the entry points of each noise
kind in a library of its own (``conv_fused.cu``: none and the hashes,
``conv_fused_threefry.cu``, and ``conv_fused_rbg.cu`` for an unsafe_rbg
key's Philox stream): an implicit GEMM on the int8 tensor
cores (``mma.sync`` m16n8k32), 16-byte ``cp.async`` gathers of each tap's
NHWC rows, 9-bit codes split into int8 planes as fragments are read, one
launch a call (the last block decodes the min / max).  Its header says
what bounds it (the bytes of the input codes and the output codes), how
the design answers that and what it measured.  Built by ``build.py`` and
called through ``ctypes`` on PyTorch's current stream.

:func:`conv3x3_fused` and :func:`conv1x1_fused` are the wrappers: a CPU
tensor takes the plain PyTorch version :func:`conv_fused_plain` (im2col,
K2's plain contraction, the epilogue in torch); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lbt_tpu_torch.ops.im2col import Pads, im2col, out_hw
from lbt_tpu_torch.ops.kernels.quant import NOISE_MODES, Noise, round_codes

_CODE_DTYPES = (torch.int8, torch.int16)


def conv_fused_plain(xc: torch.Tensor, wc: torch.Tensor,
                     inv_scale: torch.Tensor, mult_out: torch.Tensor, *,
                     strides: Tuple[int, int], pads: Pads, bits_out: int = 8,
                     noise: Optional[Noise] = None, round_bf16: bool = False):
    """Plain PyTorch version of #4 / #5 (any device):
    ``(codes [B,Ho,Wo,K] int8, moments [2,K] int64, minmax [2] f32)``.
    ``round_bf16`` rounds the conv output to bfloat16 (nearest, ties to
    even) before the min / max and the quantize, as a bf16 carrier between
    the conv and the BN input site does."""
    b, h, w, _ = xc.shape
    kh, kw, cin, cout = wc.shape
    ho, wo = out_hw(h, w, (kh, kw), strides, pads)
    patches = im2col(xc, (kh, kw), tuple(strides), pads)
    # float64 is exact here: |x * w| <= 2**15 and K <= 2**23
    acc = (patches.to(torch.float64)
           @ wc.reshape(kh * kw * cin, cout).to(torch.float64)).to(
               torch.int32)
    y = acc.to(torch.float32) * inv_scale
    if round_bf16:
        y = y.to(torch.bfloat16).to(torch.float32)
    minmax = torch.stack([y.amin(), y.amax()])
    codes = round_codes(y * mult_out, bits_out, noise)
    c64 = codes.to(torch.int64)
    moments = torch.stack([c64.sum(0), (c64 * c64).sum(0)])
    return codes.view(b, ho, wo, cout), moments, minmax


def _check(xc, wc, inv_scale, mult_out, strides, pads, bits_out, ksize,
           noise):
    if xc.dtype not in _CODE_DTYPES or wc.dtype != torch.int8:
        raise ValueError(f"need int8/int16 input codes and int8 weight "
                         f"codes, got {xc.dtype}, {wc.dtype}")
    if xc.dim() != 4 or wc.dim() != 4 or xc.shape[3] != wc.shape[2]:
        raise ValueError(f"need NHWC x HWIO, got {tuple(xc.shape)}, "
                         f"{tuple(wc.shape)}")
    if tuple(wc.shape[:2]) != ksize:
        raise ValueError(f"kernel {tuple(wc.shape[:2])} is not {ksize}")
    if not (xc.is_contiguous() and wc.is_contiguous()):
        raise ValueError("codes must be contiguous")
    for t in (wc, inv_scale, mult_out):
        if t.device != xc.device:
            raise ValueError(f"operands on {xc.device} and {t.device}")
    for t in (inv_scale, mult_out):
        if t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError("inv_scale and mult_out must be one float32 each")
    if not 1 <= bits_out <= 8:
        raise ValueError(f"bits_out={bits_out}: the codes out are int8")
    if min(strides) < 1 or min(min(p) for p in pads) < 0:
        raise ValueError(f"bad strides {strides} or pads {pads}")
    b, h, w, _ = xc.shape
    ho, wo = out_hw(h, w, ksize, strides, pads)
    if b * ho * wo * wc.shape[3] >= 2 ** 32 or xc.numel() >= 2 ** 31:
        raise ValueError("the noise counter and the kernel's int32 indices "
                         "cover smaller tensors")
    # a shared draw is one of the BN input's shape[1:] (of the whole
    # tensor, for a column slice of it), and the offset of a slice of rows
    # is then a whole number of draws
    cout = wc.shape[3]
    width = noise.n_global if noise is not None and noise.n_global else cout
    inner = ho * wo * width
    if noise is not None and (
            noise.mode not in NOISE_MODES or noise.inner not in (0, inner)
            or noise.offset < 0 or (noise.inner and noise.offset % inner)
            or not 0 <= noise.col0 <= width - cout
            or (b * ho * wo - 1) * width + noise.col0 + cout + noise.offset
            > 2 ** 32):
        raise ValueError(f"bad noise {noise}")


def _launch(entry: str, xc, wc, inv_scale, mult_out, strides, pads,
            bits_out, noise, round_bf16):
    b, h, w, cin = xc.shape
    kh, kw, _, cout = wc.shape
    ho, wo = out_hw(h, w, (kh, kw), strides, pads)
    codes = torch.empty((b, ho, wo, cout), dtype=torch.int8,
                        device=xc.device)
    # [sum q; sum q^2] per channel, then a slot of min / max keys and one
    # of the blocks' ticket counter (the last block decodes the keys)
    moments = torch.zeros(2 * cout + 2, dtype=torch.int64, device=xc.device)
    minmax = torch.empty(2, dtype=torch.float32, device=xc.device)
    dims = (ctypes.c_int * 11)(b, h, w, cin, ho, wo, cout, strides[0],
                               strides[1], pads[0][0], pads[1][0])
    from lbt_tpu_torch.ops.kernels import build
    kind = build.noise_kind(None if noise is None else noise.mode)
    fn = getattr(build.conv_fused_library(kind),
                 entry + build.CONV_FUSED_KINDS[kind][1])
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        rc = fn(xc.data_ptr(), int(xc.dtype == torch.int16), wc.data_ptr(),
                codes.data_ptr(), moments.data_ptr(), minmax.data_ptr(),
                inv_scale.data_ptr(), mult_out.data_ptr(),
                *((0, 0, 0, 0, 0, 0, 0, 0, 0) if noise is None else
                  (noise.k0 & 0xFFFFFFFF, noise.k1 & 0xFFFFFFFF,
                   noise.k2 & 0xFFFFFFFF, noise.k3 & 0xFFFFFFFF,
                   noise.inner, 0 if noise.inner else noise.offset,
                   noise.n_global, noise.col0, noise.mode)),
                int(round_bf16), bits_out, dims, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc} at x "
                           f"{tuple(xc.shape)} w {tuple(wc.shape)}")
    return codes, moments[:2 * cout].view(2, cout), minmax


def _fused(ksize, entry, counter, xc, wc, inv_scale, mult_out, strides,
           pads, bits_out, noise, round_bf16):
    strides = tuple(strides)
    pads = tuple(tuple(p) for p in pads)
    _check(xc, wc, inv_scale, mult_out, strides, pads, bits_out, ksize,
           noise)
    if xc.device.type == "cpu":
        return conv_fused_plain(xc, wc, inv_scale, mult_out, strides=strides,
                                pads=pads, bits_out=bits_out, noise=noise,
                                round_bf16=round_bf16)
    if xc.device.type != "cuda":
        raise ValueError(f"no fused conv kernel for device {xc.device}")
    out = _launch(entry, xc, wc, inv_scale, mult_out, strides, pads,
                  bits_out, noise, round_bf16)
    counter.launches += 1
    counter.launches_by_mode[0 if noise is None else noise.mode] += 1
    return out


def conv3x3_fused(xc, wc, inv_scale, mult_out, *, strides, pads,
                  bits_out: int = 8, noise: Optional[Noise] = None,
                  round_bf16: bool = False):
    """#4: 3x3 conv of int8 or 9-bit int16 codes (any stride and padding)
    with the epilogue; ``(codes, moments, minmax)`` as
    :func:`conv_fused_plain`.  int16 codes must lie in [-256, 255]: the
    kernel contracts them as split-9 int8 planes.
    ``noise=None`` rounds half-to-even, a :class:`~lbt_tpu_torch.ops.
    kernels.quant.Noise` stochastically with its stream over the flat
    NHWC index of the output (with a column window, of the whole output
    of which these are channels ``col0..``).  ``round_bf16`` as in
    :func:`conv_fused_plain`."""
    return _fused((3, 3), "lbt_conv3x3_fused", conv3x3_fused, xc, wc,
                  inv_scale, mult_out, strides, pads, bits_out, noise,
                  round_bf16)


def conv1x1_fused(xc, wc, inv_scale, mult_out, *, strides, pads,
                  bits_out: int = 8, noise: Optional[Noise] = None,
                  round_bf16: bool = False):
    """#5: 1x1 conv (rows gathered at the stride) with the same epilogue
    and contract as :func:`conv3x3_fused`."""
    return _fused((1, 1), "lbt_conv1x1_fused", conv1x1_fused, xc, wc,
                  inv_scale, mult_out, strides, pads, bits_out, noise,
                  round_bf16)


conv3x3_fused.launches = 0
conv1x1_fused.launches = 0
# the launches of each noise mode, as quantize_codes.launches_by_mode
conv3x3_fused.launches_by_mode = [0] * (1 + len(NOISE_MODES))
conv1x1_fused.launches_by_mode = [0] * (1 + len(NOISE_MODES))
