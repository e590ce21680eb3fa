"""K1: DFXP quantize to integer codes.

Replaces ``quantize_pallas`` (``lbt_tpu/ops/pallas/quant_kernels.py``,
body ``_quant_kernel`` / ``_quantize_block`` / ``_uniform01``): scale an f32
tensor by the power-of-two multiplier ``2**(bits-1-exp)``, clip to
``[-2**(bits-1), 2**(bits-1)-1]`` and round — half-to-even when
deterministic, ``floor(scaled + u)`` with ``u`` in [0, 1) when stochastic.

The kernel is CUDA C++ (``lbt_tpu_torch/csrc/quantize.cu``), one launch a
call.  It takes the site's exponent, builds the multiplier inside from its
IEEE-754 bits (exact, as :func:`multiplier` builds it here) and writes it
out beside the codes; on request (``stats=True``) it also gives the
``[min, max]`` of the scaled tensor ``x * mult``, all that a range
controller reads at a zero target rate, reduced across blocks in
the same launch (a ticket in a per-stream scratch tells the last block).
The TPU's hardware PRNG is replaced by the noise streams of ``lbt_tpu``'s
XLA paths over the row-major flat index: the counter hashes of
``xla_hash`` / ``xla_hash1`` (:func:`hash_uniform_flat`),
``jax.random.uniform``'s partitionable threefry of ``xla`` (``noise_mode=
'prng'``, :func:`threefry_uniform_flat`) and, under an ``unsafe_rbg``
key, ``jax.random.uniform``'s draw from XLA's ``rng_bit_generator``, which
is Philox4x32-10 off the TPU (:func:`rbg_uniform_flat`), each also as one
draw of ``shape[1:]`` shared along axis 0; a :class:`Noise` names the
stream, its key and that sharing.  So stochastic codes match ``lbt_tpu``
bit for bit.  The source's header says what bounds the kernel (bytes
under the hashes, integer operations under threefry and Philox) and how
its design answers.  Built by
``build.py`` and called through ``ctypes`` on PyTorch's current stream.

:func:`quantize_codes` is the wrapper: a CPU tensor takes the plain PyTorch
version :func:`quantize_codes_plain`; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from lbt_tpu_torch.dfxp.keys import PHILOX_M, PHILOX_W

_MASK32 = 0xFFFFFFFF
_INV24 = 2.0 ** -24
# lowbias32 / multiply-xorshift constants of lbt_tpu's counter hash
_HASH_M1 = 0x7FEB352D
_HASH_M2 = 0x846CA68B
# Threefry-2x32's rotations (JAX's schedule, dfxp/keys.py) and key parity
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# the kernel's grid: at most this many blocks of 256 threads an SM
BLOCKS_PER_SM = 4

Exp = Union[int, torch.Tensor]

# noise modes (the kernels' ``mode``; 0 rounds half to even)
HASH, HASH1, THREEFRY, RBG = 1, 2, 3, 4
NOISE_MODES = (HASH, HASH1, THREEFRY, RBG)


class Noise(NamedTuple):
    """The stochastic-rounding noise of one quantize call.  ``mode`` is
    :data:`HASH`, :data:`HASH1`, :data:`THREEFRY` or :data:`RBG`; ``k0``
    the hashes' 32-bit seed or the key's first word, ``k1`` its second,
    ``k2`` and ``k3`` an unsafe_rbg key's other two;
    ``inner > 0`` draws element ``i``'s noise at the counter ``i % inner``
    (``lbt_tpu``'s ``noise_shared_axis0``: one draw of ``shape[1:]``,
    ``inner = prod(shape[1:])``, broadcast along axis 0).  ``offset`` is
    added to every counter first (before the ``% inner``): it places the
    tensor's rows in a larger batch's draw, ``row0 * prod(shape[1:])`` for
    rows ``row0..`` of a global batch (``dfxp.quantize.noise_spec``).
    ``n_global > 0`` places a column slice: the tensor, read as rows of
    its last dim ``cols``, holds columns ``col0..`` of rows ``n_global``
    wide, and element ``(r, j)`` draws at ``r * n_global + col0 + j``
    (then the offset and the ``% inner``), where the whole tensor draws
    it: a tensor-parallel rank's slice of a weight or of a conv's output
    channels (``parallel/mesh.py``).  0 is no window."""
    mode: int
    k0: int
    k1: int = 0
    inner: int = 0
    offset: int = 0
    n_global: int = 0
    col0: int = 0
    k2: int = 0
    k3: int = 0


def code_dtype(bits: int) -> torch.dtype:
    """Narrowest integer dtype holding ``bits``-wide signed codes."""
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    return torch.int32


def multiplier(bits: int, exp: Exp, device=None) -> torch.Tensor:
    """``2**(bits-1-exp)`` as an exact f32 scalar tensor.

    Built from the IEEE-754 bit pattern, so it is exact on every device
    for ``-126 <= bits-1-exp <= 127`` (every exponent the controller can
    reach, ``EXP_MIN <= exp <= bits-1``), and ``inf`` above that range, as
    ``jnp.ldexp`` gives.  The kernel builds the same bits."""
    exp = torch.as_tensor(exp, device=device).to(torch.int32)
    e = (bits - 1) - exp
    pow2 = ((e.clamp(-126, 127) + 127) << 23).view(torch.float32)
    return torch.where(e > 127, math.inf, pow2)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 tensors holding uint32 values,
    split in 16-bit halves so no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


Window = Optional[Tuple[int, int, int]]


def _counters(n: int, inner: int, device, offset: int = 0,
              window: Window = None) -> torch.Tensor:
    """int64 counters of ``n`` flat indices: ``i + offset``, or that
    ``% inner``; a ``window`` ``(cols, n_global, col0)`` first takes
    ``i`` of element ``(r, j)`` of rows ``cols`` long to ``r * n_global +
    col0 + j`` (:class:`Noise`)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    if window is not None:
        cols, n_global, col0 = window
        i = (torch.div(i, cols, rounding_mode="floor") * n_global + col0
             + i % cols)
    i += offset
    return i % inner if inner else i


def hash_uniform_flat(seed: int, n: int, light: bool, device=None,
                      inner: int = 0, offset: int = 0,
                      window: Window = None) -> torch.Tensor:
    """Uniform [0, 1) f32 noise: the top 24 bits of the uint32 counter
    hash of ``arange(n) ^ seed``, as ``lbt_tpu/dfxp/quantize.py:
    _hash_uniform`` computes it — the lowbias32 finalizer
    (``noise_mode='hash'``) or, with ``light``, one multiply-xorshift
    round (``'hash1'``).  The counters are ``arange(n) + offset``, ``%
    inner`` when ``inner > 0``, the indices first placed by ``window``
    (:func:`_counters`)."""
    x = _counters(n, inner, device, offset, window) ^ (seed & _MASK32)
    if not light:
        x = x ^ (x >> 16)
    x = _mul32(x, _HASH_M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _HASH_M2)
    if not light:
        x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * _INV24


def _rotl32(v: torch.Tensor, r: int) -> torch.Tensor:
    t = (v << r).bitwise_and_(_MASK32)
    return t.bitwise_or_(v >> (32 - r))


def threefry_uniform_flat(k0: int, k1: int, n: int, inner: int = 0,
                          device=None, offset: int = 0,
                          window: Window = None) -> torch.Tensor:
    """Uniform [0, 1) f32 noise equal to ``jax.random.uniform(key, shape,
    float32)`` for a key of raw data ``(k0, k1)`` and ``n = prod(shape)``,
    under ``jax_threefry_partitionable`` (JAX's default): element ``i`` is
    the Threefry-2x32 cipher of the counter ``(hi32(c), lo32(c))``, ``c =
    i + offset`` (or that ``% inner``; ``i`` placed by ``window`` first),
    its two words xored, the top 23 bits as the mantissa of 1.0, minus 1.
    In int64 torch ops masked to 32 bits, as ``dfxp/keys.py:threefry2x32``
    runs the cipher in numpy."""
    c = _counters(n, inner, device, offset, window)
    ks = (k0 & _MASK32, k1 & _MASK32, (k0 ^ k1 ^ _KS_PARITY) & _MASK32)
    x0 = (c >> 32).add_(ks[0]).bitwise_and_(_MASK32)
    x1 = c.bitwise_and_(_MASK32).add_(ks[1]).bitwise_and_(_MASK32)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK32)
            x1 = _rotl32(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_MASK32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _mulhilo(c: torch.Tensor, m: int):
    """``(hi32, lo32)`` of ``c * m`` for an int64 tensor holding uint32
    values and a 32-bit constant, from 16-bit halves of ``m`` so that no
    int64 product overflows."""
    pl = c * (m & 0xFFFF)                   # < 2**48
    ph = c * (m >> 16)
    return ((ph + (pl >> 16)) >> 16,
            (((ph & 0xFFFF) << 16) + pl) & _MASK32)


def _philox_blocks(key4, blocks: torch.Tensor) -> torch.Tensor:
    """``[len(blocks), 4]`` int64 words: the Philox4x32-10 blocks ``blocks``
    (int64, below 2**62) of an unsafe_rbg key's stream, the counter
    ``(s0 << 64 | s1) + b`` with its carries (``dfxp/keys.py:rbg_bits``),
    the key ``(k0, k1)``."""
    k0, k1, k2, k3 = (int(v) & _MASK32 for v in key4)
    t = blocks + k2
    c1 = (t >> 32) + k3
    c2 = (c1 >> 32) + k0
    c3 = ((c2 >> 32) + k1) & _MASK32
    c0, c1, c2 = t & _MASK32, c1 & _MASK32, c2 & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & _MASK32
        k1 = (k1 + PHILOX_W[1]) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _rbg_words(key4, start: int, n: int, device) -> torch.Tensor:
    """Words ``start .. start + n - 1`` of the key's stream (int64): the
    blocks that hold them, once each."""
    b0 = start >> 2
    blocks = torch.arange(b0, (start + n + 3) >> 2, dtype=torch.int64,
                          device=device)
    words = _philox_blocks(key4, blocks).reshape(-1)
    return words[start - 4 * b0:start - 4 * b0 + n]


def rbg_uniform_flat(key4, n: int, inner: int = 0, device=None,
                     offset: int = 0, window: Window = None) -> torch.Tensor:
    """Uniform [0, 1) f32 noise equal to ``jax.random.uniform(key, shape,
    float32)`` for an unsafe_rbg key of raw data ``key4`` (4 words) and
    ``n = prod(shape)``, as XLA draws it off the TPU: element ``i`` is word
    ``c % 4`` of the Philox4x32-10 block ``c // 4`` of the key's stream,
    ``c = i + offset`` (or that ``% inner``; ``i`` placed by ``window``
    first), the top 23 bits as the mantissa of 1.0, minus 1.  In int64
    torch ops: each block once where the counters run in order (no
    window), a block an element under a window."""
    if window is None and not inner:
        bits = _rbg_words(key4, offset, n, device)
    elif window is None:
        bits = _rbg_words(key4, 0, inner, device)[
            _counters(n, inner, device, offset)]
    else:
        c = _counters(n, inner, device, offset, window)
        bits = _philox_blocks(key4, c >> 2).gather(
            1, (c & 3)[:, None]).squeeze(1)
    bits = (bits >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def noise_uniform(noise: Noise, n: int, device=None,
                  cols: int = 0) -> torch.Tensor:
    """The ``n`` uniforms of ``noise``'s stream over the flat index of a
    tensor whose last dim is ``cols`` (which places a column window)."""
    window = (cols, noise.n_global, noise.col0) if noise.n_global else None
    if noise.mode == RBG:
        return rbg_uniform_flat(
            (noise.k0, noise.k1, noise.k2, noise.k3), n, noise.inner,
            device, noise.offset, window)
    if noise.mode == THREEFRY:
        return threefry_uniform_flat(noise.k0, noise.k1, n, noise.inner,
                                     device, noise.offset, window)
    return hash_uniform_flat(noise.k0, n, noise.mode == HASH1, device,
                             noise.inner, noise.offset, window)


def round_codes(scaled: torch.Tensor, bits: int,
                noise: Optional[Noise] = None) -> torch.Tensor:
    """Codes of an already scaled f32 tensor ``x * mult``: clipped, then
    rounded half-to-even (``noise=None``) or as ``floor(scaled + u)`` with
    ``noise``'s uniforms over the flat index (any device; a column window
    reads ``scaled`` as rows of its last dim)."""
    limit = float(2 ** (bits - 1))
    if noise is None:
        codes = torch.round(torch.clamp(scaled, -limit, limit - 1))
    else:
        u = noise_uniform(noise, scaled.numel(), scaled.device,
                          scaled.shape[-1] if scaled.dim() else 1)
        codes = torch.floor(
            torch.clamp(scaled + u.view(scaled.shape), -limit, limit - 1))
    return codes.to(code_dtype(bits))


@torch.no_grad()
def quantize_codes_plain(x: torch.Tensor, bits: int, exp: Exp,
                         noise: Optional[Noise] = None, stats: bool = False):
    """Plain PyTorch version of K1 (any device): ``(codes, mult)`` or
    ``(codes, mult, minmax)``, outside autograd as the kernel's are."""
    mult = multiplier(bits, exp, x.device)
    scaled = x * mult.reshape(())
    codes = round_codes(scaled, bits, noise)
    if stats:
        return codes, mult, torch.stack([scaled.amin(), scaled.amax()])
    return codes, mult


def noise_end(noise: Noise, x: torch.Tensor) -> int:
    """One past the largest counter that ``noise`` draws for ``x`` (the
    counters must stay below 2**32); raises ``ValueError`` on a column
    window that does not fit ``x``."""
    n = x.numel()
    if not noise.n_global:
        return noise.offset + n
    cols = x.shape[-1] if x.dim() else 1
    if not cols or noise.col0 < 0 or noise.col0 + cols > noise.n_global:
        raise ValueError(f"column window {noise} does not fit "
                         f"{tuple(x.shape)}")
    return ((n // cols - 1) * noise.n_global + noise.col0 + cols
            + noise.offset) if n else noise.offset


@functools.cache
def _max_blocks(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count * BLOCKS_PER_SM


@functools.cache
def _const_exp(device: torch.device, value: int) -> torch.Tensor:
    """A Python-int exponent as a one-element int32 on ``device``, made
    once (never written: the wrapper only hands out its pointer)."""
    return torch.tensor(value, dtype=torch.int32, device=device)


# (device index, stream) -> int32 [SCRATCH_WORDS]: the min/max keys and the
# ticket counter (``csrc/quantize.cu``), which every call leaves at 0
SCRATCH_WORDS = 64
_SCRATCH: dict = {}


def _scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The min/max reduction's scratch for the current stream, zeroed when
    first made and then cached, so two streams never share a ticket and a
    call needs no fill.  A call captured into a CUDA graph on a stream
    that has made no eager call gets a scratch of its own, zeroed inside
    the graph and not kept (warm up on the capturing stream, as PyTorch's
    graph capture asks, and the graph holds one launch a call)."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = torch.zeros(SCRATCH_WORDS, dtype=torch.int32, device=device)
        if not torch.cuda.is_current_stream_capturing():
            _SCRATCH[key] = buf
    return buf


def _launch(x: torch.Tensor, bits: int, exp: Exp, noise: Optional[Noise],
            stats: bool):
    dev = x.device
    with torch.cuda.device(dev):
        if isinstance(exp, torch.Tensor):
            e = exp.to(device=dev, dtype=torch.int32)
        else:
            e = _const_exp(dev, int(exp))
        codes = torch.empty(x.shape, dtype=code_dtype(bits), device=dev)
        mult = torch.empty(e.shape, dtype=torch.float32, device=dev)
        minmax = torch.empty(2, dtype=torch.float32, device=dev) \
            if stats else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch(dev, stream) if stats else None
        from lbt_tpu_torch.ops.kernels.build import quantize_library
        rc = quantize_library().lbt_quantize(
            x.data_ptr(), codes.data_ptr(), codes.element_size(), x.numel(),
            e.data_ptr(), mult.data_ptr(),
            None if minmax is None else minmax.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _max_blocks(dev.index), bits,
            *((0, 0, 0, 0, 0, 0, 0, 0, 0, 0) if noise is None else
              (noise.k0 & _MASK32, noise.k1 & _MASK32, noise.k2 & _MASK32,
               noise.k3 & _MASK32, noise.inner, noise.offset,
               x.shape[-1] if x.dim() else 1, noise.n_global, noise.col0,
               noise.mode)), stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc} at "
                           f"{tuple(x.shape)} bits={bits}")
    return (codes, mult, minmax) if stats else (codes, mult)


def quantize_codes(x: torch.Tensor, bits: int, exp: Exp,
                   noise: Optional[Noise] = None, stats: bool = False):
    """DFXP codes of ``x`` (f32, contiguous, any shape) in
    :func:`code_dtype` of ``bits``, at the exponent ``exp``.

    ``exp`` is a one-element int32 tensor on ``x``'s device (another
    integer tensor is converted there) or a Python int.  Returns
    ``(codes, mult)``, ``mult`` the f32 multiplier ``2**(bits-1-exp)`` in
    ``exp``'s shape.  ``noise=None`` rounds half-to-even; a
    :class:`Noise` rounds stochastically with its stream (its column
    window reads ``x`` as rows of its last dim).  ``stats=True``
    returns ``(codes, mult, minmax)`` with
    ``minmax`` the f32 ``[min, max]`` of ``x * mult`` (``x`` must not be
    empty)."""
    if not 1 <= bits < 32:
        raise ValueError(f"bits={bits} outside 1..31")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"x must be contiguous float32, got {x.dtype} "
            f"contiguous={x.is_contiguous()}")
    if isinstance(exp, torch.Tensor) and (
            exp.numel() != 1 or exp.is_floating_point()):
        raise ValueError(f"exp must be one integer, got {exp.dtype} "
                         f"x{exp.numel()}")
    if x.numel() >= 2 ** 32:
        raise ValueError("the noise counter covers at most 2**32 elements")
    if noise is not None and (noise.mode not in NOISE_MODES
                              or not 0 <= noise.inner < 2 ** 32
                              or noise.offset < 0
                              or noise_end(noise, x) > 2 ** 32):
        raise ValueError(f"bad noise {noise}")
    if stats and not x.numel():
        raise ValueError("min / max of an empty tensor")
    if x.device.type == "cpu":
        return quantize_codes_plain(x, bits, exp, noise, stats)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x.device}")
    out = _launch(x, bits, exp, noise, stats)
    quantize_codes.launches += 1
    quantize_codes.launches_by_mode[0 if noise is None else noise.mode] += 1
    return out


quantize_codes.launches = 0
# the launches of each noise mode (0: round to nearest, then HASH, HASH1,
# THREEFRY, RBG)
quantize_codes.launches_by_mode = [0] * (1 + len(NOISE_MODES))
