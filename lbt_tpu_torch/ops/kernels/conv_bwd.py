"""The int8 conv backward: dgrad and wgrad as implicit GEMMs that gather
their taps as they load, with no im2col patches, padded copy or
zero-dilated cotangent.

They replace no Pallas kernel: ``lbt_tpu``'s XLA emitted the conv's
transposes for its integer engine (``lbt_tpu/ops/qops.py``,
``_dx_conv_params`` and the dW conv).  The kernels are CUDA C++ in
``lbt_tpu_torch/csrc/conv_bwd.cu``: ``mma.sync`` m16n8k32 int8 tensor-core
tiles fed by 16-byte ``cp.async`` copies of each tap's NHWC rows,
zero-filled outside the image; dgrad splits a strided conv's input pixels
into stride classes, each a dense problem over its own taps, and wgrad is
K2's ``X^T . g`` main loop with a gathering loader.  Its header says what
bounds them (the operands' bytes) and how the design answers that.  Built
by ``build.py`` and called through ``ctypes`` on PyTorch's current stream.

:func:`int8_conv_dgrad` and :func:`int8_conv_wgrad` are the wrappers: a
CPU tensor takes the plain PyTorch versions :func:`int8_conv_dgrad_plain`
and :func:`int8_conv_wgrad_plain` (one float64 contraction a tap over the
strided slices it reads, exact); a CUDA tensor launches the kernel or
raises.  The kernels take channel counts that are multiples of 16
(:func:`implicit`); the callers route other convs through im2col and K2.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from lbt_tpu_torch.ops.im2col import Pads, out_hw
from lbt_tpu_torch.ops.kernels.gemm import split9

_INT_MAX = 2 ** 31 - 1


def implicit(cin: int, cout: int) -> bool:
    """Whether the kernels take a conv of these channel counts: both
    multiples of 16, so that every tap's channel rows are whole 16-byte
    copies."""
    return cin % 16 == 0 and cout % 16 == 0


def _taps(size: int, osize: int, k: int, stride: int, lo: int):
    """The output positions ``[o0, o1)`` that tap ``k`` reads inside the
    input (``o * stride + k - lo`` in ``[0, size)``), and the first input
    position they read."""
    o0 = max(0, -((k - lo) // stride))
    o1 = min(osize, (size - 1 + lo - k) // stride + 1)
    return o0, max(o0, o1), o0 * stride + k - lo


def int8_conv_dgrad_plain(gc: torch.Tensor, wc: torch.Tensor, x_hw,
                          strides, pads: Pads,
                          inv: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of dgrad (any device): ``dx [B,H,W,Cin]``, the
    input gradient of an NHWC x HWIO conv from the cotangent codes ``gc``
    ``[B,Ho,Wo,Cout]``.  Each tap adds ``g . W[i,j]^T`` at the input pixels
    it reads, in float64, which is exact for int8 codes; the sums are
    rounded like the kernel: int32, then f32 times ``inv`` (int32 when
    ``inv`` is None)."""
    b, ho, wo, cout = gc.shape
    kh, kw, cin, _ = wc.shape
    (h, w), (sh, sw), ((ph, _), (pw, _)) = x_hw, strides, pads
    g64, w64 = gc.to(torch.float64), wc.to(torch.float64)
    acc = torch.zeros((b, h, w, cin), dtype=torch.float64, device=gc.device)
    for i in range(kh):
        a0, a1, h0 = _taps(h, ho, i, sh, ph)
        for j in range(kw):
            c0, c1, w0 = _taps(w, wo, j, sw, pw)
            if a0 < a1 and c0 < c1:
                acc[:, h0:h0 + (a1 - a0 - 1) * sh + 1:sh,
                    w0:w0 + (c1 - c0 - 1) * sw + 1:sw] += (
                        g64[:, a0:a1, c0:c1] @ w64[i, j].t())
    acc = acc.to(torch.int32)
    return acc if inv is None else acc.to(torch.float32) * inv


def int8_conv_wgrad_plain(xc: torch.Tensor, gc: torch.Tensor, ksize,
                          strides, pads: Pads) -> torch.Tensor:
    """Plain PyTorch version of wgrad (any device): ``dW`` as int64
    ``[kh*kw*Cin, Cout]`` (rows in HWI order) from the input codes ``xc``
    (int8, or 9-bit int16) and the cotangent codes ``gc``.  Each tap
    contracts the strided slice of ``xc`` it reads with ``gc`` in float64,
    exact (products of at most 2**15 over fewer than 2**38 pixels)."""
    b, h, w, cin = xc.shape
    _, ho, wo, cout = gc.shape
    (kh, kw), (sh, sw), ((ph, _), (pw, _)) = ksize, strides, pads
    x64, g64 = xc.to(torch.float64), gc.to(torch.float64)
    out = torch.zeros((kh, kw, cin, cout), dtype=torch.int64,
                      device=xc.device)
    for i in range(kh):
        a0, a1, h0 = _taps(h, ho, i, sh, ph)
        for j in range(kw):
            c0, c1, w0 = _taps(w, wo, j, sw, pw)
            if a0 < a1 and c0 < c1:
                xs = x64[:, h0:h0 + (a1 - a0 - 1) * sh + 1:sh,
                         w0:w0 + (c1 - c0 - 1) * sw + 1:sw]
                out[i, j] = (xs.reshape(-1, cin).t() @ g64[
                    :, a0:a1, c0:c1].reshape(-1, cout)).to(torch.int64)
    return out.view(kh * kw * cin, cout)


def _check(xshape: Sequence[int], gc: torch.Tensor, wshape, strides,
           pads: Pads, codes=()) -> None:
    """The shapes of one conv's backward: input ``xshape`` (NHWC), kernel
    ``wshape`` (HWIO), cotangent ``gc`` (int8 NHWC) of the conv's output
    size, and every tensor of ``codes`` contiguous on ``gc``'s device."""
    if gc.dtype != torch.int8:
        raise ValueError(f"cotangent codes must be int8, got {gc.dtype}")
    if len(xshape) != 4 or gc.dim() != 4 or len(wshape) != 4:
        raise ValueError(f"need NHWC x HWIO, got x {tuple(xshape)}, "
                         f"w {tuple(wshape)}, g {tuple(gc.shape)}")
    b, h, w, cin = xshape
    kh, kw, wcin, cout = wshape
    if min(strides) < 1 or min(min(p) for p in pads) < 0:
        raise ValueError(f"bad strides {strides} or pads {pads}")
    ho, wo = out_hw(h, w, (kh, kw), strides, pads)
    if wcin != cin or tuple(gc.shape) != (b, ho, wo, cout):
        raise ValueError(f"cotangent {tuple(gc.shape)} is not the output "
                         f"of x {tuple(xshape)} and w {tuple(wshape)}")
    for t in (gc, *codes):
        if not t.is_contiguous():
            raise ValueError("codes must be contiguous")
        if t.device != gc.device:
            raise ValueError(f"operands on {gc.device} and {t.device}")
    if b * h * w * max(cin, cout) > _INT_MAX or kh * kw * cin > _INT_MAX:
        raise ValueError(f"the kernels' int32 pixel counts cover smaller "
                         f"convs than x {tuple(xshape)}")


def _cuda_ready(name: str, tensors, cin: int, cout: int) -> None:
    """Raise unless the kernel ``name`` takes these operands."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {tensors[0].device}")
    if not implicit(cin, cout):
        raise ValueError(f"{name} needs Cin and Cout multiples of 16, got "
                         f"{cin}, {cout}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned operands")


def _dims(xshape, wshape, strides, pads, ho_wo) -> ctypes.Array:
    b, h, w, cin = xshape
    kh, kw, _, cout = wshape
    return (ctypes.c_int * 13)(b, h, w, cin, *ho_wo, cout, kh, kw,
                               strides[0], strides[1], pads[0][0],
                               pads[1][0])


def int8_conv_dgrad(gc: torch.Tensor, wc: torch.Tensor, x_hw, strides,
                    pads: Pads, inv: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``dx [B,H,W,Cin]`` of an NHWC x HWIO conv of an ``x_hw``-sized input
    from the cotangent's int8 codes ``gc`` and the weight codes ``wc``
    (int8): exact int32 sums, or f32 ``acc * inv`` (``inv`` a one-element
    f32 tensor on the operands' device), K2's epilogue."""
    strides = tuple(strides)
    pads = tuple(tuple(p) for p in pads)
    b, _, _, cout = gc.shape
    xshape = (b, *x_hw, wc.shape[2])
    if wc.dtype != torch.int8:
        raise ValueError(f"weight codes must be int8, got {wc.dtype}")
    _check(xshape, gc, wc.shape, strides, pads, (wc,))
    if inv is not None and (inv.dtype != torch.float32 or inv.numel() != 1
                            or inv.device != gc.device):
        raise ValueError(
            f"inv must be one float32 element on {gc.device}, got "
            f"{inv.dtype} x{inv.numel()} on {inv.device}")
    if gc.device.type == "cpu":
        return int8_conv_dgrad_plain(gc, wc, x_hw, strides, pads, inv)
    _cuda_ready("dgrad", (gc, wc), wc.shape[2], cout)
    out = torch.empty(xshape, device=gc.device,
                      dtype=torch.int32 if inv is None else torch.float32)
    from lbt_tpu_torch.ops.kernels.build import conv_bwd_library
    lib = conv_bwd_library()
    with torch.cuda.device(gc.device):
        stream = torch.cuda.current_stream(gc.device).cuda_stream
        rc = lib.lbt_conv_dgrad(
            gc.data_ptr(), wc.data_ptr(), out.data_ptr(),
            None if inv is None else inv.data_ptr(),
            _dims(xshape, wc.shape, strides, pads, gc.shape[1:3]), stream)
    if rc != 0:
        raise RuntimeError(f"conv dgrad launch failed: cudaError {rc} at g "
                           f"{tuple(gc.shape)} w {tuple(wc.shape)} x {x_hw}")
    int8_conv_dgrad.launches += 1
    return out


int8_conv_dgrad.launches = 0


def int8_conv_wgrad(xc: torch.Tensor, gc: torch.Tensor,
                    ksize: Tuple[int, int], strides, pads: Pads
                    ) -> torch.Tensor:
    """``dW`` of an NHWC x HWIO conv as exact int64 ``[kh*kw*Cin, Cout]``
    (rows in HWI order) from the input codes ``xc`` (int8, or 9-bit int16:
    its split-9 planes ``h = x >> 1`` and ``l = x - 2h`` take a launch
    each, summed as ``2 dW(h) + dW(l)``) and the cotangent's int8 codes
    ``gc``."""
    strides = tuple(strides)
    pads = tuple(tuple(p) for p in pads)
    kh, kw = ksize
    cin, cout = xc.shape[3], gc.shape[3]
    if xc.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"input codes must be int8 or int16, got "
                         f"{xc.dtype}")
    _check(tuple(xc.shape), gc, (kh, kw, cin, cout), strides, pads, (xc,))
    if gc.device.type == "cpu":
        return int8_conv_wgrad_plain(xc, gc, ksize, strides, pads)
    _cuda_ready("wgrad", (xc, gc), cin, cout)
    if -(-gc.numel() // cout // 2 ** 16) > 65535:
        raise ValueError(f"{gc.numel() // cout} pixels need more than "
                         f"65535 splits")
    planes = split9(xc) if xc.dtype == torch.int16 else (xc,)
    from lbt_tpu_torch.ops.kernels.build import conv_bwd_library
    lib = conv_bwd_library()
    outs = []
    for plane in planes:
        out = torch.zeros((kh * kw * cin, cout), dtype=torch.int64,
                          device=xc.device)
        with torch.cuda.device(xc.device):
            stream = torch.cuda.current_stream(xc.device).cuda_stream
            rc = lib.lbt_conv_wgrad(
                plane.data_ptr(), gc.data_ptr(), out.data_ptr(),
                _dims(xc.shape, (kh, kw, cin, cout), strides, pads,
                      gc.shape[1:3]), stream)
        if rc != 0:
            raise RuntimeError(f"conv wgrad launch failed: cudaError {rc} "
                               f"at x {tuple(xc.shape)} g "
                               f"{tuple(gc.shape)} k {tuple(ksize)}")
        int8_conv_wgrad.launches += 1
        outs.append(out)
    return outs[0] if len(outs) == 1 else 2 * outs[0] + outs[1]


int8_conv_wgrad.launches = 0
