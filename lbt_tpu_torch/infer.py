"""Serving and deployment (PyTorch port of ``lbt_tpu/infer.py``): a predict
function and a ``Predictor`` handle, on the card unless asked for the CPU;
BatchNorm folding; the export of integer weight codes.

The serving forward runs the model's engine with running BN statistics,
deterministic round-half-even quantization, dropout off and no state
updates (``Ctx(train=False, update=False)``).  A trained model deploys
as:

* a :class:`Predictor` loaded from ``lbt_tpu``'s numpy trees, from a
  checkpoint of the port's ``Trainer`` (:meth:`Predictor.from_checkpoint`)
  or from a restored export, optionally with BN folded
  (:func:`fold_batchnorm`);
* an exported artifact of integer weight codes and exponents
  (:func:`export_quantized_weights`): weights ship as int8 (4x smaller
  than f32), or as nibble-packed uint8 at 4 bits or fewer (8x smaller),
  with one int32 exponent a tensor, and restore exactly onto the DFXP
  grid (:func:`restore_quantized_weights`).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from lbt_tpu_torch.convert import from_jax_numpy
from lbt_tpu_torch.dfxp.quantize import (EXP_MIN, dequantize, multiplier,
                                         quantize_int)
from lbt_tpu_torch.nn.blocks import ResidualBlock
from lbt_tpu_torch.nn.core import Ctx, Layer, Sequential
from lbt_tpu_torch.nn.layers import Conv2d, Dense
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.nn.norm import (BatchNorm, FusedBatchNorm, Normalization,
                                   sqrt_f32)
from lbt_tpu_torch.train import checkpoint as ckpt
from lbt_tpu_torch.utils.device import full_f32, resolve_device


def make_predict_fn(model: Model, return_probs: bool = False):
    """``x -> labels [, probs]`` for NHWC f32 ``x`` on the model's device."""
    ctx = Ctx(train=False, update=False)

    @full_f32()
    @torch.inference_mode()
    def predict(x: torch.Tensor):
        logits = model.apply(x, ctx)
        labels = logits.argmax(dim=-1)
        if return_probs:
            return labels, torch.softmax(logits, dim=-1)
        return labels

    return predict


# ---------------------------------------------------------------------------
# BatchNorm folding (serving-time graph transform)
# ---------------------------------------------------------------------------


def _fit_exponent(x, bits: int) -> int:
    """Smallest DFXP exponent whose grid covers max|x| without clipping,
    with the controller's upper clamp ``exp <= bits - 1``; in float64 on
    the host, as ``lbt_tpu``'s."""
    maxabs = float(np.max(np.abs(np.asarray(x))))
    if maxabs == 0.0:
        return 0
    limit = 2.0 ** (bits - 1) - 1  # codes clip at [-2^(b-1), 2^(b-1)-1]
    e = int(np.ceil(np.log2(maxabs / limit))) + bits - 1
    return max(min(e, bits - 1), EXP_MIN)


def _bn_affine(bn: BatchNorm):
    """``(scale, shift)`` of a BatchNorm at eval time, ``y = x * scale +
    shift`` on the running statistics (f32, correctly rounded root)."""
    inner = list(bn.layers)
    if len(inner) == 1 and isinstance(inner[0], FusedBatchNorm):
        stats = aff = inner[0]
        eps = inner[0].eps
    else:
        norm, aff = inner
        assert isinstance(norm, Normalization)
        stats, eps = norm, norm.eps
    scale = aff.gamma / sqrt_f32(stats.var + eps)
    return scale, aff.beta - stats.mean * scale


def _fold_pair(lyr: Layer, bn: BatchNorm) -> Layer:
    """``lyr`` (Conv2d or Dense) with ``bn`` folded in: ``bn(W x + b) ==
    (W * scale) x + (b * scale + shift)``, ``scale`` over the output
    channels (W's last axis), as one biased layer of the same name whose
    weight and bias exponents are refit to the folded tensors."""
    scale, shift = _bn_affine(bn)
    W = lyr.W * scale
    b = shift + (lyr.b * scale if lyr.use_bias else 0.0)
    cfg = lyr.cfg
    if isinstance(lyr, Conv2d):
        folded = Conv2d(lyr.name, cfg, lyr.ksize, lyr.strides, lyr.padding,
                        use_bias=True, weight_decay=lyr.weight_decay)
    else:
        folded = Dense(lyr.name, cfg, lyr.in_units, lyr.units,
                       use_bias=True, weight_decay=lyr.weight_decay)
    folded.to(W.device)
    folded.W.copy_(W)
    folded.b.copy_(b)
    for site in lyr.exp_sites():
        folded.exp(site).copy_(lyr.exp(site))
    if "w" in folded.exp_sites():
        folded.exp("w").fill_(_fit_exponent(W.cpu(), cfg.bits_w))
    if "b" in folded.exp_sites():
        folded.exp("b").fill_(_fit_exponent(b.cpu(), cfg.bits_b))
    return folded


def _fold_inplace(layer: Layer) -> None:
    """Rewrite ``layer``'s subtree (a copy, safe to change): inside every
    Sequential, a Conv2d or Dense followed by a BatchNorm becomes one
    folded layer; residual blocks fold both branches."""
    if isinstance(layer, Sequential):
        kids, out, i = list(layer.layers), [], 0
        while i < len(kids):
            nxt = kids[i + 1] if i + 1 < len(kids) else None
            if isinstance(kids[i], (Conv2d, Dense)) and isinstance(
                    nxt, BatchNorm):
                out.append(_fold_pair(kids[i], nxt))
                i += 2
                continue
            _fold_inplace(kids[i])
            out.append(kids[i])
            i += 1
        layer.layers = torch.nn.ModuleList(out)
    elif isinstance(layer, ResidualBlock):  # incl. ResidualBottleneck
        _fold_inplace(layer.residual)
        _fold_inplace(layer.shortcut)


@torch.no_grad()
def fold_batchnorm(model: Model) -> Model:
    """A new :class:`Model`, ``model`` with every Conv2d/Dense + BatchNorm
    pair replaced by one biased layer whose weights absorb the running
    statistics' affine (``W' = W * gamma / sqrt(var + eps)``, ``b' = beta -
    mean * gamma / sqrt(var + eps)`` plus the folded old bias), the weight
    and bias exponents refit to the folded tensors.  ``model`` is left
    intact.

    A deployment artifact: the BN input's quantize site is gone, eval runs
    one pass less a BN, and the folded model must not be trained (the
    statistics are frozen into the weights)."""
    net = copy.deepcopy(model.net)
    _fold_inplace(net)
    return Model(model.name, list(net.layers), model.input_shape,
                 model.num_classes, model.cfg)


# ---------------------------------------------------------------------------
# quantized weight export
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantizedLeaf:
    """One exported weight: integer ``codes`` (int8 at 8 bits or fewer,
    int16 to 16 bits, else int32; uint8 nibble pairs when ``packed``) on
    the grid of the int32 exponent ``exp`` at ``bits``, of ``shape``."""
    codes: torch.Tensor
    exp: torch.Tensor
    bits: int
    packed: bool = False
    shape: Tuple[int, ...] = ()


def _pack4(codes: torch.Tensor) -> torch.Tensor:
    """Codes in ``[-8, 7]`` -> uint8 nibble pairs: offset binary ``code +
    8``, the even flat index in the low nibble, an odd count padded with a
    zero nibble."""
    flat = (codes.reshape(-1).to(torch.int16) + 8).to(torch.uint8)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pair = flat.view(-1, 2)
    return pair[:, 0] | (pair[:, 1] << 4)


def _unpack4(packed: torch.Tensor, shape) -> torch.Tensor:
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    flat = torch.stack([lo, hi], dim=1).reshape(-1)
    return flat[:math.prod(shape)].reshape(tuple(shape))


_SITE_OF = {"W": "w", "b": "b", "gamma": "gamma", "beta": "beta"}


@torch.no_grad()
def export_quantized_weights(model: Model) -> Dict:
    """The model's parameters as integer codes on their current exponents,
    in ``lbt_tpu``'s params layout (container -> child name -> ..., a leaf
    layer -> parameter name -> leaf).  A parameter with a quantize site
    (``W`` -> ``w``, ``b``, ``gamma``, ``beta``) exports as a
    :class:`QuantizedLeaf` of K1's deterministic codes, the rounded grid
    points the serving forward uses; any other stays a float tensor.  On
    the CPU, whatever the model's device."""
    cfg = model.cfg
    bits_of = {"W": cfg.bits_w, "b": cfg.bits_b, "gamma": cfg.bits_b,
               "beta": cfg.bits_b}

    def walk(layer: Layer) -> Dict:
        children = layer.sublayers()
        if children:
            return {c.name: walk(c) for c in children}
        out = {}
        for k, p in layer.named_parameters(recurse=False):
            site = _SITE_OF.get(k)
            if site is None or site not in layer.exp_sites():
                out[k] = p.detach().cpu().clone()
                continue
            bits, exp = bits_of[k], layer.exp(site)
            codes, _ = quantize_int(p.detach(), bits, exp)
            codes, exp = codes.cpu(), exp.detach().cpu().clone()
            if bits <= 4:
                out[k] = QuantizedLeaf(_pack4(codes), exp, bits,
                                       packed=True, shape=tuple(p.shape))
            else:
                out[k] = QuantizedLeaf(codes, exp, bits,
                                       shape=tuple(p.shape))
        return out

    return walk(model.net)


def restore_quantized_weights(exported: Mapping) -> Dict:
    """An exported tree back to float parameters (f32 tensors in the same
    layout), each value exactly on the DFXP grid the forward quantizes to."""

    def walk(node):
        if isinstance(node, QuantizedLeaf):
            codes = (_unpack4(node.codes, node.shape) if node.packed
                     else node.codes)
            return dequantize(codes, multiplier(node.bits, node.exp))
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(exported)


def exported_nbytes(exported: Mapping) -> Tuple[int, int]:
    """``(quantized_bytes, float32_bytes)`` of an exported tree: codes plus
    4 bytes of exponent a leaf, float leaves at their size; against every
    leaf as f32."""
    qb = fb = 0

    def walk(node):
        nonlocal qb, fb
        if isinstance(node, QuantizedLeaf):
            qb += node.codes.numel() * node.codes.element_size() + 4
            fb += math.prod(node.shape) * 4
        elif isinstance(node, Mapping):
            for v in node.values():
                walk(v)
        else:
            qb += node.numel() * node.element_size()
            fb += node.numel() * 4

    walk(exported)
    return qb, fb


# ---------------------------------------------------------------------------
# serving handle
# ---------------------------------------------------------------------------


class Predictor:
    """Serving handle.  ``params`` / ``qstate``, when given, are
    ``lbt_tpu``'s trees as numpy arrays (``params`` may be a restored
    export's tree of tensors) and are loaded into ``model``; ``fold_bn``
    then folds BN (:func:`fold_batchnorm`); the model moves to
    ``device``: the card by default (raising without one), the CPU only
    when ``device="cpu"``.

    >>> p = Predictor.from_checkpoint(model, "exp/ckpt", fold_bn=True)
    >>> labels = p(batch)
    """

    def __init__(self, model: Model, params: Optional[Mapping] = None,
                 qstate: Optional[Mapping] = None, *, fold_bn: bool = False,
                 device=None):
        if (params is None) != (qstate is None):
            raise ValueError("give both params and qstate, or neither")
        if params is not None:
            from_jax_numpy(model, params, qstate)
        if fold_bn:
            model = fold_batchnorm(model)
        model.to(resolve_device(device))
        self.model = model
        self.device = model.device
        self._fn = make_predict_fn(model)

    @classmethod
    def from_checkpoint(cls, model: Model, directory: str,
                        step: Optional[int] = None, *, fold_bn: bool = False,
                        device=None) -> "Predictor":
        """Serve the checkpoint of ``step`` (default the latest) that the
        port's ``Trainer`` wrote under ``directory`` for this model."""
        state = ckpt.restore_checkpoint(directory, {
            "model": model.net.state_dict(),
            "velocity": {k: torch.empty_like(p) for k, p in
                         model.net.named_parameters()},
            "epoch": 0, "step": 0}, step)
        model.net.load_state_dict(state["model"])
        return cls(model, fold_bn=fold_bn, device=device)

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return self._fn(x.contiguous())
