"""A ResNet-50 DFXP training step in plain PyTorch, the reference of the
cells.

The architecture is He et al. 2015 (arXiv:1512.03385), Table 1, 50 layers,
NHWC: a bias-free 7x7/2 stem conv, BN, ReLU, a 3x3/2 SAME max pool, four
stages of bottlenecks (1x1, 3x3 at the stage's stride, 1x1 to 4x the
width; a 1x1 strided conv + BN on the shortcut where the shape changes),
global average pooling and a dense head with a bias.  Convs pad as
TensorFlow's SAME (the extra row and column at the end).

DFXP (dynamic fixed point) rules, per quantize site:

- a tensor ``t`` at ``bits`` and exponent ``e`` becomes the codes
  ``floor(clip(t * m + u, -2**(bits-1), 2**(bits-1)-1))``, ``m =
  2**(bits-1-e)``, ``u`` the site's uniform noise (:mod:`.noise`); its
  value is ``codes / m``; the gradient passes straight through;
- sites: each conv's and dense layer's input (conv inputs at ``bits_a +
  conv_act_extra``), weight, and output cotangent (``bits_g``, a barrier
  that is the identity forward); the dense bias; each BN layer's input,
  gamma and beta (``bits_b``) and output cotangent;
- the range controller of a site reads ``[min, max]`` of ``t * m`` and
  moves ``e`` by +1 if anything clips at full range, -1 if nothing clips at
  half range, else 0 (clipped to ``[-110, bits-1]``), in steps where the
  controllers run (``step % range_update_every == 0`` or before
  ``range_update_warmup_steps``); forward sites commit after the step,
  gradient sites from their cotangent's statistics;
- BN takes the batch moments of its quantized input from exact sums of the
  codes (``var = E[x^2] - mean^2``), EMA-updates its running statistics,
  and with ``fused_bn`` is one layer ``(xq - mean) * (gq / s) + bq``, else
  ``(xq - mean) / s`` then ``xq * gq + bq``, each with its own sites;
- contractions: ``engine='int8'`` sums the codes exactly and scales once to
  f32; ``'sim_bf16'`` rounds the exact sums (forward, and both backward
  contractions) to bf16;
- every layer computes in f32 and casts its output to the carrier
  (``act_dtype``); the ReLUs, residual sums and max pool run in it.

Contractions are exact here: sums of products of codes in float64 (exact
below 2**53), one GEMM a kernel tap.  Then SGD with momentum and the
in-gradient weight decay ``g + 2 wd w`` on conv / dense weights and gamma.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import noise

SITE_X, SITE_W, SITE_B, SITE_G = 0, 1, 2, 3
SITE_GAMMA, SITE_BETA = 1, 2
N_SITES = 5
EXP_MIN = -110
STAGES = {50: (3, 4, 6, 3)}
QUANT_KEYS = ("bits_w", "bits_a", "bits_b", "bits_g", "conv_act_extra",
              "engine", "noise_mode", "fused_bn", "act_dtype",
              "range_update_every", "range_update_warmup_steps",
              "initial_exponent", "bn_momentum", "target_overflow_rate",
              "stochastic")


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the reference computes: the model, the DFXP scheme and the
    recipe, from a configuration file's ``model``, ``quant`` and ``train``."""
    depth: int
    image_size: int
    num_classes: int
    quant: Dict
    lr: float
    momentum: float
    weight_decay: float

    @classmethod
    def from_config(cls, cfg: Dict, **quant_overrides) -> "Spec":
        m, t = cfg["model"], cfg["train"]
        quant = {k: cfg["quant"][k] for k in QUANT_KEYS}
        quant.update(quant_overrides)
        if quant["target_overflow_rate"] != 0.0 or not quant["stochastic"]:
            raise ValueError("the reference takes stochastic rounding at a "
                             "zero overflow target")
        if quant["engine"] not in ("int8", "sim_bf16"):
            raise ValueError(f"engine {quant['engine']!r}")
        fixed = {"noise_shared_axis0": False, "noise_impl": "threefry2x32",
                 "stem_s2d": False, "initial_exponent_g": None}
        for k, v in fixed.items():
            if cfg["quant"].get(k, v) != v:
                raise ValueError(f"the reference takes {k}={v!r}")
        return cls(m["depth"], m["image_size"], m["num_classes"], quant,
                   t["lr"], t["momentum"], t["weight_decay"])

    @property
    def carrier(self) -> torch.dtype:
        return torch.bfloat16 if self.quant["act_dtype"] == "bf16" \
            else torch.float32

    @property
    def bits_conv(self) -> int:
        q = self.quant
        return min(q["bits_a"] + q["conv_act_extra"], 32)


# -- the architecture ---------------------------------------------------------


@dataclasses.dataclass
class Node:
    """One layer of the tree; ``uid`` is its depth-first index, ``path``
    the parameter-name prefix of a module tree that nests children in
    ``layers`` lists."""
    kind: str
    uid: int
    path: str
    args: Dict
    children: List["Node"] = dataclasses.field(default_factory=list)


class Builder:
    def __init__(self):
        self.uid = 0

    def node(self, kind, path, **args) -> Node:
        n = Node(kind, self.uid, path, args)
        self.uid += 1
        return n

    def seq(self, path, makers) -> Node:
        """A sequential container; ``makers`` build its children in order,
        each from its path."""
        n = Node("seq", self.uid, path, {})
        self.uid += 1
        n.children = [make(f"{path}layers.{i}.")
                      for i, make in enumerate(makers)]
        return n


def _conv(b: Builder, k, cin, cout, s):
    return lambda p: b.node("conv", p, ksize=(k, k, cin, cout),
                            strides=(s, s))


def _bn(b: Builder, spec: Spec, c):
    if spec.quant["fused_bn"]:
        return lambda p: b.seq(p, [lambda q: b.node("fused_bn", q, c=c)])
    return lambda p: b.seq(p, [lambda q: b.node("norm", q, c=c),
                               lambda q: b.node("rescale", q, c=c)])


def _relu(b: Builder):
    return lambda p: b.node("relu", p)


def _block(b: Builder, spec: Spec, cin, c, s):
    def make(p):
        n = b.node("block", p)
        n.children = [
            b.seq(p + "residual.", [
                _conv(b, 1, cin, c, 1), _bn(b, spec, c), _relu(b),
                _conv(b, 3, c, c, s), _bn(b, spec, c), _relu(b),
                _conv(b, 1, c, 4 * c, 1), _bn(b, spec, 4 * c)]),
            b.seq(p + "shortcut.", [] if s == 1 and cin == 4 * c else
                  [_conv(b, 1, cin, 4 * c, s), _bn(b, spec, 4 * c)])]
        return n
    return make


def build(spec: Spec) -> Tuple[Node, int]:
    """The tree and the number of uids."""
    b = Builder()
    makers = [_conv(b, 7, 3, 64, 2), _bn(b, spec, 64), _relu(b),
              lambda p: b.node("maxpool", p)]
    cin, feat = 64, spec.image_size // 4
    for i, (c, n) in enumerate(zip((64, 128, 256, 512), STAGES[spec.depth])):
        s = 1 if i == 0 else 2
        for j in range(n):
            makers.append(_block(b, spec, cin, c, s if j == 0 else 1))
            cin = 4 * c
        feat = -(-feat // s)
    makers += [lambda p: b.node("avgpool", p, k=feat),
               lambda p: b.node("flatten", p),
               lambda p: b.node("dense", p, cin=cin, cout=spec.num_classes)]
    root = b.seq("", makers)
    return root, b.uid


def walk(n: Node):
    yield n
    for c in n.children:
        yield from walk(c)


def leaves(spec: Spec) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every trainable tensor in the tree's order: ``(name, shape, init,
    weight decay)``, ``init`` one of ``'uniform:<limit>'``, ``'ones'``,
    ``'zeros'``."""
    root, _ = build(spec)
    wd = spec.weight_decay
    out = []
    for n in walk(root):
        if n.kind == "conv":
            kh, kw, cin, _ = n.args["ksize"]
            out.append((n.path + "W", n.args["ksize"],
                        f"uniform:{math.sqrt(3.0 / (kh * kw * cin))}", wd))
        elif n.kind == "dense":
            cin, cout = n.args["cin"], n.args["cout"]
            out += [(n.path + "W", (cin, cout),
                     f"uniform:{math.sqrt(6.0 / (cin + cout))}", wd),
                    (n.path + "b", (cout,), "zeros", 0.0)]
        elif n.kind in ("fused_bn", "rescale"):
            c = n.args["c"]
            out += [(n.path + "gamma", (c,), "ones", wd),
                    (n.path + "beta", (c,), "zeros", 0.0)]
    return out


def init_params(spec: Spec, gen: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """Initial weights from ``gen``: one uniform draw for every weight at
    once, each leaf its slice scaled to ``U(-limit, limit)``; gamma 1,
    beta and the bias 0."""
    ls = leaves(spec)
    total = sum(math.prod(s) for _, s, init, _ in ls
                if init.startswith("uniform"))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init, _ in ls:
        if init.startswith("uniform"):
            lim = float(init.split(":")[1])
            n = math.prod(shape)
            out[name] = (u[at:at + n] * (2 * lim) - lim).view(shape)
            at += n
        else:
            out[name] = (torch.ones if init == "ones" else torch.zeros)(
                shape, device=device)
    return out


# -- quantization ------------------------------------------------------------


def mult(bits: int, exp: int) -> float:
    return 2.0 ** (bits - 1 - exp)


def codes_of(t: torch.Tensor, bits: int, exp: int, key, mode: str):
    """``(codes as f32, m, [min, max] of t * m)``, stochastic rounding."""
    m = mult(bits, exp)
    scaled = t.detach().to(torch.float32) * m
    lim = float(2 ** (bits - 1))
    u = noise.uniform(mode, key, scaled.numel(), scaled.device)
    codes = torch.floor(torch.clamp(scaled + u.view(scaled.shape), -lim,
                                    lim - 1))
    return codes, m, torch.stack([scaled.amin(), scaled.amax()])


def step_exponent(exp: int, mn: float, mx: float, bits: int) -> int:
    lim = float(2 ** (bits - 1))
    if mx >= lim or mn < -lim:
        d = 1
    elif mx >= lim / 2 or mn < -lim / 2:
        d = 0
    else:
        d = -1
    return max(EXP_MIN, min(bits - 1, exp + d))


def _code_dtype(bits):
    return torch.int8 if bits <= 8 else torch.int16


# -- exact contractions: one float64 GEMM a kernel tap ------------------------


def _geom(x_hw, ksize, strides):
    pads = []
    for n, k, s in zip(x_hw, ksize, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    out = [(n + sum(p) - k) // s + 1
           for n, k, s, p in zip(x_hw, ksize, strides, pads)]
    return pads, out


def _taps(kh, kw, strides, out):
    (sh, sw), (ho, wo) = strides, out
    for i in range(kh):
        for j in range(kw):
            yield i, j, (slice(None), slice(i, i + sh * (ho - 1) + 1, sh),
                         slice(j, j + sw * (wo - 1) + 1, sw))


def conv64(x, w, strides):
    """NHWC ``x`` x HWIO ``w`` (float64), SAME."""
    kh, kw, _, cout = w.shape
    ((pt, pb), (pl, pr)), out = _geom(x.shape[1:3], (kh, kw), strides)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    y = x.new_zeros((x.shape[0], *out, cout))
    for i, j, sl in _taps(kh, kw, strides, out):
        y += xp[sl] @ w[i, j]
    return y


def conv64_dx(g, w, x_shape, strides):
    kh, kw = w.shape[:2]
    b, h, wd, cin = x_shape
    ((pt, pb), (pl, pr)), out = _geom((h, wd), (kh, kw), strides)
    dxp = g.new_zeros((b, h + pt + pb, wd + pl + pr, cin))
    for i, j, sl in _taps(kh, kw, strides, out):
        dxp[sl] += g @ w[i, j].t()
    return dxp[:, pt:pt + h, pl:pl + wd]


def conv64_dw(x, g, ksize, strides):
    kh, kw = ksize
    ((pt, pb), (pl, pr)), out = _geom(x.shape[1:3], (kh, kw), strides)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    c, g2 = x.shape[-1], g.reshape(-1, g.shape[-1])
    dw = x.new_zeros((kh, kw, c, g2.shape[-1]))
    for i, j, sl in _taps(kh, kw, strides, out):
        dw[i, j] = xp[sl].reshape(-1, c).t() @ g2
    return dw


class _Contract(torch.autograd.Function):
    """``xq . wq`` (a conv with ``strides``, or a matmul when ``strides``
    is None), exact, then f32 (int8) or bf16 (sim_bf16).  The gradient
    reaches ``x`` and ``w`` straight through their quantizers."""

    @staticmethod
    def forward(ctx, x, w, xc, mx, wc, mw, strides, bf16):
        ctx.save_for_backward(xc, wc)
        ctx.mx, ctx.mw, ctx.strides, ctx.bf16 = mx, mw, strides, bf16
        ctx.x_shape = x.shape
        a, b = xc.to(torch.float64), wc.to(torch.float64)
        y = (a @ b if strides is None else conv64(a, b, strides)) / (mx * mw)
        y = y.to(torch.float32)
        return y.to(torch.bfloat16).to(torch.float32) if bf16 else y

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        g64 = g.to(torch.float64)
        xq = xc.to(torch.float64) / ctx.mx
        wq = wc.to(torch.float64) / ctx.mw
        dx = dw = None
        if ctx.strides is None:
            if ctx.needs_input_grad[0]:
                dx = g64 @ wq.t()
            dw = xq.t() @ g64
        else:
            if ctx.needs_input_grad[0]:
                dx = conv64_dx(g64, wq, ctx.x_shape, ctx.strides)
            dw = conv64_dw(xq, g64, wq.shape[:2], ctx.strides)
        dx = None if dx is None else _round(dx, ctx.bf16)
        return dx, _round(dw, ctx.bf16), None, None, None, None, None, None


def _round(t64, bf16):
    t = t64.to(torch.float32)
    return t.to(torch.bfloat16).to(torch.float32) if bf16 else t


# -- the per-step state and the layers ----------------------------------------


class Step:
    """One training step's context: keys, whether the controllers run, the
    exponents read, and the statistics gathered for their update."""

    def __init__(self, ref: "Reference", step: int):
        self.ref = ref
        q = ref.spec.quant
        self.controls = (q["range_update_every"] == 1
                         or step % q["range_update_every"] == 0
                         or step < q["range_update_warmup_steps"])
        self.keys = noise.site_keys(noise.fold_in(ref.base_key, step),
                                    ref.n_uids, N_SITES)
        self.fwd_stats: List[Tuple[Tuple[int, str], int, torch.Tensor]] = []
        self.grad_stats: Dict[int, torch.Tensor] = {}
        self.ema: List[Tuple[str, torch.Tensor]] = []

    def key(self, uid, site):
        return tuple(int(v) for v in self.keys[uid, site])

    def quant(self, uid, site, name, t, bits):
        """``(codes, m)`` of ``t`` at the site, its controller staged."""
        exp = self.ref.exps[(uid, name)]
        codes, m, mm = codes_of(t, bits, exp, self.key(uid, site),
                                self.ref.spec.quant["noise_mode"])
        if self.controls:
            self.fwd_stats.append(((uid, name), bits, mm))
        return codes, m

    def fake(self, uid, site, name, t, bits):
        """STE fake-quantize: the codes' value forward, identity backward."""
        codes, m = self.quant(uid, site, name, t, bits)
        return codes / m + (t - t.detach())


class _Barrier(torch.autograd.Function):
    """Identity forward; the backward quantizes the cotangent at the
    layer's gradient site and keeps its statistics for the controller."""

    @staticmethod
    def forward(ctx, y, st, uid):
        ctx.st, ctx.uid = st, uid
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        st, uid = ctx.st, ctx.uid
        bits = st.ref.spec.quant["bits_g"]
        codes, m, mm = codes_of(g, bits, st.ref.exps[(uid, "grad")],
                                st.key(uid, SITE_G),
                                st.ref.spec.quant["noise_mode"])
        st.grad_stats[uid] = mm if st.controls else None
        return (codes / m).to(g.dtype), None, None


def _out(st: Step, n: Node, y: torch.Tensor) -> torch.Tensor:
    return _Barrier.apply(y, st, n.uid).to(st.ref.spec.carrier)


def _qcodes(st, n, site, name, t, bits):
    codes, m = st.quant(n.uid, site, name, t, bits)
    return codes.to(_code_dtype(bits)), m


def conv_fwd(st: Step, n: Node, x, params):
    q, spec = st.ref.spec.quant, st.ref.spec
    x = x.to(torch.float32)
    w = params[n.path + "W"]
    xc, mx = _qcodes(st, n, SITE_X, "x", x, spec.bits_conv)
    wc, mw = _qcodes(st, n, SITE_W, "w", w, q["bits_w"])
    y = _Contract.apply(x, w, xc, mx, wc, mw, n.args["strides"],
                        q["engine"] == "sim_bf16")
    return _out(st, n, y)


def dense_fwd(st: Step, n: Node, x, params):
    q = st.ref.spec.quant
    x = x.to(torch.float32)
    w, b = params[n.path + "W"], params[n.path + "b"]
    xc, mx = _qcodes(st, n, SITE_X, "x", x, q["bits_a"])
    wc, mw = _qcodes(st, n, SITE_W, "w", w, q["bits_w"])
    y = _Contract.apply(x, w, xc, mx, wc, mw, None,
                        q["engine"] == "sim_bf16")
    y = y + st.fake(n.uid, SITE_B, "b", b, q["bits_b"])
    return _out(st, n, y)


def _moments(codes, m):
    """Biased batch mean and variance of ``codes / m`` per channel, from
    exact integer sums (float64, rounded once to f32)."""
    c = codes.reshape(-1, codes.shape[-1]).to(torch.int64)
    n = c.shape[0]
    s0 = c.sum(0).to(torch.float64)
    s1 = (c * c).sum(0).to(torch.float64)
    mean = s0 / n / m
    var = s1 / n / (m * m) - mean * mean
    return mean.to(torch.float32), var.to(torch.float32)


def _sqrt32(t):
    return torch.sqrt(t.to(torch.float64)).to(torch.float32)


class _FusedBN(torch.autograd.Function):
    """``(xq - mean) * (gq / s) + bq``, ``s = sqrt(var + eps)``, with the
    batch moments' gradient (``var = m2 - mean^2``); the gradient reaches
    ``x``, gamma and beta straight through their quantizers."""

    @staticmethod
    def forward(ctx, x, gamma, beta, codes, m, gq, bq, mean, var, eps):
        s = _sqrt32(var + eps)
        xq = codes.to(torch.float32) / m
        ctx.save_for_backward(codes, gq, mean, s)
        ctx.m = m
        return (xq - mean) * (gq / s) + bq

    @staticmethod
    def backward(ctx, g):
        codes, gq, mean, s = ctx.saved_tensors
        xq = codes.to(torch.float32) / ctx.m
        axes = tuple(range(g.dim() - 1))
        n = g.numel() // g.shape[-1]
        r = gq / s
        d_r = (g * (xq - mean)).sum(axes)
        d_var = ((-d_r) * gq * (1.0 / (s * s))) * (0.5 / s)
        d_mean = -(g * r).sum(axes) - 2.0 * mean * d_var
        dx = g * r + d_mean / n + (d_var / n) * (2.0 * xq)
        return (dx, d_r / s, g.sum(axes), None, None, None, None, None, None,
                None)


class _Normalize(torch.autograd.Function):
    """``(xq - mean) / s`` with the batch moments' gradient."""

    @staticmethod
    def forward(ctx, x, codes, m, mean, var, eps):
        s = _sqrt32(var + eps)
        xq = codes.to(torch.float32) / m
        ctx.save_for_backward(codes, mean, s)
        ctx.m = m
        return (xq - mean) / s

    @staticmethod
    def backward(ctx, g):
        codes, mean, s = ctx.saved_tensors
        xq = codes.to(torch.float32) / ctx.m
        axes = tuple(range(g.dim() - 1))
        n = g.numel() // g.shape[-1]
        d_s = ((-g) * (xq - mean) * (1.0 / (s * s))).sum(axes)
        d_m2 = d_s * (0.5 / s)
        d_mean = -(g / s).sum(axes) - 2.0 * mean * d_m2
        dx = g / s + d_mean / n + (d_m2 / n) * (2.0 * xq)
        return dx, None, None, None, None, None


class _Rescale(torch.autograd.Function):
    """``xq * gq + bq``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, codes, m, gq, bq):
        ctx.save_for_backward(codes, gq)
        ctx.m = m
        return (codes.to(torch.float32) / m) * gq + bq

    @staticmethod
    def backward(ctx, g):
        codes, gq = ctx.saved_tensors
        axes = tuple(range(g.dim() - 1))
        xq = codes.to(torch.float32) / ctx.m
        return (g * gq, (g * xq).sum(axes), g.sum(axes), None, None, None,
                None)


EPS = 1e-5


def _bn_input(st, n, x):
    q = st.ref.spec.quant
    codes, m = _qcodes(st, n, SITE_X, "x", x.to(torch.float32), q["bits_a"])
    return x.to(torch.float32), codes, m


def _affine(st, n, params):
    q = st.ref.spec.quant
    gamma, beta = params[n.path + "gamma"], params[n.path + "beta"]
    gq = st.quant(n.uid, SITE_GAMMA, "gamma", gamma, q["bits_b"])
    bq = st.quant(n.uid, SITE_BETA, "beta", beta, q["bits_b"])
    return gamma, beta, gq[0] / gq[1], bq[0] / bq[1]


def _ema(st, n, mean_b, var_b):
    mom = st.ref.spec.quant["bn_momentum"]
    bufs = st.ref.buffers
    st.ema.append((n.path + "mean",
                   mom * bufs[n.path + "mean"] + (1 - mom) * mean_b))
    st.ema.append((n.path + "var",
                   mom * bufs[n.path + "var"] + (1 - mom) * var_b))


def fused_bn_fwd(st: Step, n: Node, x, params):
    x, codes, m = _bn_input(st, n, x)
    gamma, beta, gq, bq = _affine(st, n, params)
    mean, var = _moments(codes, m)
    _ema(st, n, mean, var)
    return _out(st, n, _FusedBN.apply(x, gamma, beta, codes, m, gq, bq,
                                      mean, var, EPS))


def norm_fwd(st: Step, n: Node, x, params):
    x, codes, m = _bn_input(st, n, x)
    mean, var = _moments(codes, m)
    _ema(st, n, mean, var)
    return _out(st, n, _Normalize.apply(x, codes, m, mean, var, EPS))


def rescale_fwd(st: Step, n: Node, x, params):
    x, codes, m = _bn_input(st, n, x)
    gamma, beta, gq, bq = _affine(st, n, params)
    return _out(st, n, _Rescale.apply(x, gamma, beta, codes, m, gq, bq))


class _MaxPool(torch.autograd.Function):
    """3x3/2 SAME max pool padded with -inf.  A window's cotangent goes to
    its first maximum in row-major order; an input position sums the
    windows that chose it in row-major order of the windows, in the
    cotangent's dtype."""

    @staticmethod
    def forward(ctx, x):
        (pt, pb), (pl, pr) = _geom(x.shape[1:3], (3, 3), (2, 2))[0]
        out = _geom(x.shape[1:3], (3, 3), (2, 2))[1]
        xp = F.pad(x, (0, 0, pl, pr, pt, pb), value=float("-inf"))
        taps = list(_taps(3, 3, (2, 2), out))
        y = xp[taps[0][2]].clone()
        arg = torch.zeros(y.shape, dtype=torch.uint8, device=x.device)
        for t, (_, _, sl) in enumerate(taps[1:], 1):
            v = xp[sl]
            take = v > y
            y = torch.where(take, v, y)
            arg.masked_fill_(take, t)
        ctx.save_for_backward(arg)
        ctx.geom = (x.shape, xp.shape, pt, pl, taps)
        return y

    @staticmethod
    def backward(ctx, g):
        (arg,) = ctx.saved_tensors
        shape, pshape, pt, pl, taps = ctx.geom
        dxp = g.new_zeros(pshape)
        for t in reversed(range(len(taps))):
            dxp[taps[t][2]] += torch.where(arg == t, g, 0.0)
        return dxp[:, pt:pt + shape[1], pl:pl + shape[2]]


def forward(st: Step, n: Node, x, params):
    k = n.kind
    if k == "seq":
        for c in n.children:
            x = forward(st, c, x, params)
        return x
    if k == "block":
        s = (forward(st, n.children[0], x, params)
             + forward(st, n.children[1], x, params))
        return torch.where(s > 0, s, 0.0)
    if k == "relu":
        return torch.where(x > 0, x, 0.0)
    if k == "maxpool":
        return _MaxPool.apply(x)
    if k == "avgpool":
        f = n.args["k"]
        return (x.to(torch.float32).sum(dim=(1, 2))
                / float(f * f)).to(x.dtype)
    if k == "flatten":
        return x.reshape(x.shape[0], -1)
    return {"conv": conv_fwd, "dense": dense_fwd, "fused_bn": fused_bn_fwd,
            "norm": norm_fwd, "rescale": rescale_fwd}[k](st, n, x, params)


def loss_of(logits, labels):
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    onehot = labels.to(torch.int64)[:, None] == torch.arange(
        logits.shape[-1], device=logits.device)
    return (logz - torch.where(onehot, logits, 0.0).sum(-1)).mean()


# -- the training state -------------------------------------------------------


def _exp_sites(n: Node, spec: Spec):
    q = spec.quant
    return {"conv": [("x", spec.bits_conv), ("w", q["bits_w"]),
                     ("grad", q["bits_g"])],
            "dense": [("x", q["bits_a"]), ("w", q["bits_w"]),
                      ("grad", q["bits_g"]), ("b", q["bits_b"])],
            "fused_bn": [("x", q["bits_a"]), ("gamma", q["bits_b"]),
                         ("beta", q["bits_b"]), ("grad", q["bits_g"])],
            "norm": [("x", q["bits_a"]), ("grad", q["bits_g"])],
            "rescale": [("x", q["bits_a"]), ("gamma", q["bits_b"]),
                        ("beta", q["bits_b"]), ("grad", q["bits_g"])],
            }.get(n.kind, [])


class Reference:
    """The model's parameters, velocity, BN running statistics and
    exponents, and :meth:`step`."""

    def __init__(self, spec: Spec, params: Dict[str, torch.Tensor],
                 key_seed: int):
        self.spec = spec
        self.root, self.n_uids = build(spec)
        self.base_key = noise.base_key(key_seed)
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.decay = {name: wd for name, _, _, wd in leaves(spec)}
        self.velocity = {k: torch.zeros_like(v)
                         for k, v in self.params.items()}
        dev = next(iter(params.values())).device
        self.buffers, self.exps, self.bits, self.paths = {}, {}, {}, {}
        for n in walk(self.root):
            for site, bits in _exp_sites(n, spec):
                if bits < 32:
                    self.exps[(n.uid, site)] = spec.quant["initial_exponent"]
                    self.bits[(n.uid, site)] = bits
                    self.paths[(n.uid, site)] = f"{n.path}exp_{site}"
            if n.kind in ("fused_bn", "norm"):
                self.buffers[n.path + "mean"] = torch.zeros(
                    n.args["c"], device=dev)
                self.buffers[n.path + "var"] = torch.ones(
                    n.args["c"], device=dev)
        self.grad_uids = [uid for (uid, s) in self.exps if s == "grad"]

    def exponents(self) -> Dict[str, int]:
        """Every exponent by its module-tree name (``<path>exp_<site>``)."""
        return {self.paths[k]: v for k, v in self.exps.items()}

    def step(self, x: torch.Tensor, y: torch.Tensor, step: int) -> float:
        """One training step on ``x`` (NHWC f32) and labels ``y``; returns
        the loss."""
        spec = self.spec
        st = Step(self, step)
        for p in self.params.values():
            p.grad = None
        loss = loss_of(forward(st, self.root, x, self.params), y)
        loss.backward()
        with torch.no_grad():
            # forward sites, then gradient sites, from one host read
            reads = [mm for _, _, mm in st.fwd_stats] + [
                st.grad_stats[u] for u in self.grad_uids
                if st.grad_stats.get(u) is not None]
            vals = (torch.stack(reads).cpu().tolist() if reads else [])
            it = iter(vals)
            for site, bits, _ in st.fwd_stats:
                mn, mx = next(it)
                self.exps[site] = step_exponent(self.exps[site], mn, mx,
                                                bits)
            for u in self.grad_uids:
                k = (u, "grad")
                if u not in st.grad_stats:   # no cotangent reached it
                    self.exps[k] = step_exponent(self.exps[k], 0.0, 0.0,
                                                 self.bits[k])
                elif st.grad_stats[u] is not None:
                    mn, mx = next(it)
                    self.exps[k] = step_exponent(self.exps[k], mn, mx,
                                                 self.bits[k])
            for name, v in st.ema:
                self.buffers[name] = v
            for k, p in self.params.items():
                g = p.grad
                if self.decay[k]:
                    g = g + (2.0 * self.decay[k]) * p.detach()
                v = self.velocity[k]
                v.copy_(spec.momentum * v + g)
                p.copy_(p - spec.lr * v)
                p.grad = None
        return loss.item()
