#!/usr/bin/env python3
"""Time K1, K2 and #4/#5 built from another version of their CUDA sources
beside this checkout's, at every call shape of ResNet-20's serving forward
and training step (batch 128), or of the bench headline's ResNet-50
training step (``--resnet50``: 224 px, batch 128, its controllers' 1-in-8
cadence), in one run on one CUDA card; with ``--old-k1``, also the Triton
K1 of a version that had one beside this checkout's CUDA K1.

    mkdir -p lbt_tpu_torch/_build/old
    git archive <commit> lbt_tpu_torch/csrc \\
        [lbt_tpu_torch/ops/kernels/quant_triton.py] \\
        | tar -x -C lbt_tpu_torch/_build/old
    python3 compare_csrc.py lbt_tpu_torch/_build/old/lbt_tpu_torch/csrc \\
        [--pre-threefry | --pre-offset | --pre-window | --pre-rbg] \\
        [--resnet50] \\
        [--kernels k1,fused] \\
        [--old-k1 lbt_tpu_torch/_build/old/lbt_tpu_torch/ops/kernels/quant_triton.py] \\
        [--out chiprun_out/compare.json]

The other sources must keep the C interface of ``ops/kernels/build.py``,
or with ``--pre-rbg`` the one before the unsafe_rbg key's noise (mode 4)
was added (71da3f9 and older: K1 and #4/#5 took two key words, and
#4/#5's modes were one library; no call here may draw mode 4), or with
``--pre-window`` the one before the noise counter's column window
was added (1dd7f99 and older: K1 and #4/#5 took no window; every call
here has none), or with ``--pre-offset`` the one before the noise
counter's offset was
added (6563fe7 and older: K1 and #4/#5 took no offset; every call here
has offset 0), or with ``--pre-threefry`` the one before threefry noise
was added (K1 took a seed and a mode, #4/#5 a seed and two flags): then
only the hashes' calls with an unshared draw are timed, which that
interface takes.  The CUDA K1 is compared where the other sources have
``quantize.cu``.  The Triton K1 is loaded by file path and needs
``triton``.  It takes the
multiplier, which the old path built from the exponent in torch ops at
every site: its rows give the kernel alone (``old_ms``) and the site as
the old path ran it, those ops included (``old_site_ms``).  Each shape is
timed as ``chip_smoke.py`` times its kernels (one CUDA graph replayed over
input copies that overflow L2), in turns: new, old, old, new (Triton K1:
new, old, site, site, old, new).  Both
versions must equal the plain version bitwise.  Prints each shape and the
totals a serving forward and a training step (calls x ms), old and new.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import chip_smoke as cs


def _codes(shape, lim, gen, dtype=torch.int8):
    return torch.randint(-lim, lim, shape, generator=gen, dtype=dtype).cuda()


def _no_offset(offset):
    if offset:
        raise ValueError("sources from before the noise offset draw at "
                         "offset 0 only")


def _no_rbg_k1(a):
    """K1's arguments without an unsafe_rbg key's words ``k2, k3``, which
    the call's noise must not draw (mode 4)."""
    if a[19] == 4:
        raise ValueError("sources from before mode 4 draw no Philox noise")
    return a[:12] + a[14:]


def _no_rbg_conv(a):
    """#4/#5's arguments without ``k2, k3`` (mode 4 raises)."""
    if a[16] == 4:
        raise ValueError("sources from before mode 4 draw no Philox noise")
    return a[:10] + a[12:]


def _behind_rbg(libs: dict) -> dict:
    """``libs`` (K1 and #4/#5 that take the C interface from before mode
    4, :func:`_pre_rbg`'s) behind this checkout's."""
    k1 = libs["quantize_library"].lbt_quantize

    def lbt_quantize(*a, fn=k1):
        return fn(*_no_rbg_k1(a))

    entries = {}
    for name in ("lbt_conv3x3_fused", "lbt_conv1x1_fused"):
        def entry(*a, fn=getattr(libs["conv_fused_library"], name)):
            return fn(*_no_rbg_conv(a))

        entries[name] = staticmethod(entry)
    return {"quantize_library": type("K1", (), {
                "lbt_quantize": staticmethod(lbt_quantize)}),
            "conv_fused_library": type("Fused", (), entries)}


def _one_library(lib) -> dict:
    """#4/#5 of sources from before one library a noise kind (71da3f9 and
    older: every mode's entry points in one) as this checkout's three:
    ``{kind: entry points named with the kind's suffix}``."""
    from lbt_tpu_torch.ops.kernels.build import CONV_FUSED_KINDS
    return {kind: type("Fused", (), {
                f"lbt_conv{k}x{k}_fused{suffix}": staticmethod(
                    getattr(lib, f"lbt_conv{k}x{k}_fused")) for k in (3, 1)})
            for kind, (_, suffix) in CONV_FUSED_KINDS.items()}


def _pre_rbg(build, csrc: Path) -> dict:
    """The K1 and #4/#5 libraries of ``csrc``, sources from before the
    unsafe_rbg key's mode 4, behind this checkout's C interface."""
    k1_lib = ctypes.CDLL(str(build.build_library(
        "quantize", ["quantize.cu"], csrc=csrc)))
    k1_lib.lbt_quantize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int] + [ctypes.c_uint32] * 7 + [
        ctypes.c_int, ctypes.c_void_p]
    k1_lib.lbt_quantize.restype = ctypes.c_int
    conv_lib = ctypes.CDLL(str(build.build_library(
        "conv_fused", ["conv_fused.cu"], csrc=csrc)))
    for name in ("lbt_conv3x3_fused", "lbt_conv1x1_fused"):
        fn = conv_lib[name]
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_void_p] * 6 + [ctypes.c_uint32] * 6 + [
            ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int),
                                 ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return _behind_rbg({"quantize_library": k1_lib,
                        "conv_fused_library": conv_lib})


def _no_window_k1(a):
    """K1's arguments without the column window ``(cols, n_global,
    col0)``, which must be off."""
    if a[15]:
        raise ValueError("sources from before the column window draw "
                         "without one only")
    return a[:14] + a[17:]


def _no_window_conv(a):
    """#4/#5's arguments without the column window ``(n_global, col0)``,
    which must be off."""
    if a[12]:
        raise ValueError("sources from before the column window draw "
                         "without one only")
    return a[:12] + a[14:]


def _pre_window(build, csrc: Path) -> dict:
    """The K1 and #4/#5 libraries of ``csrc``, sources from before the
    noise counter's column window, behind this checkout's C interface
    (their entry points take no window; one that is on raises)."""
    k1_lib = ctypes.CDLL(str(build.build_library(
        "quantize", ["quantize.cu"], csrc=csrc)))
    fn = k1_lib["lbt_quantize"]
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def lbt_quantize(*a, fn=fn):
        return fn(*_no_window_k1(a))

    conv_lib = ctypes.CDLL(str(build.build_library(
        "conv_fused", ["conv_fused.cu"], csrc=csrc)))
    entries = {}
    for name in ("lbt_conv3x3_fused", "lbt_conv1x1_fused"):
        fn = conv_lib[name]
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def entry(*a, fn=fn):
            return fn(*_no_window_conv(a))

        entries[name] = staticmethod(entry)
    return {"quantize_library": type("K1", (), {
                "lbt_quantize": staticmethod(lbt_quantize)}),
            "conv_fused_library": type("Fused", (), entries)}


def _pre_offset(build, csrc: Path) -> dict:
    """The K1 and #4/#5 libraries of ``csrc``, sources from before the
    noise counter's offset, behind this checkout's C interface (their
    entry points take no ``offset``; a non-zero one raises)."""
    k1_lib = ctypes.CDLL(str(build.build_library(
        "quantize", ["quantize.cu"], csrc=csrc)))
    fn = k1_lib["lbt_quantize"]
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def lbt_quantize(*a, fn=fn):
        *head, offset, mode, stream = _no_window_k1(a)
        _no_offset(offset)
        return fn(*head, mode, stream)

    conv_lib = ctypes.CDLL(str(build.build_library(
        "conv_fused", ["conv_fused.cu"], csrc=csrc)))
    entries = {}
    for name in ("lbt_conv3x3_fused", "lbt_conv1x1_fused"):
        fn = conv_lib[name]
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def entry(*a, fn=fn):
            a = _no_window_conv(a)
            _no_offset(a[11])
            return fn(*a[:11], *a[12:])

        entries[name] = staticmethod(entry)
    return {"quantize_library": type("K1", (), {
                "lbt_quantize": staticmethod(lbt_quantize)}),
            "conv_fused_library": type("Fused", (), entries)}


def _pre_threefry(build, csrc: Path) -> dict:
    """The K1 and #4/#5 libraries of ``csrc``, sources from before
    threefry noise, behind this checkout's C interface: K1's
    ``lbt_quantize`` took ``(seed, mode)`` and #4/#5's entry points
    ``(seed, stochastic, light)`` where this checkout's take ``(k0, k1,
    inner, mode)``; a threefry or shared draw raises."""
    def unshared_hash(k1, inner, mode):
        if mode == 3 or inner:
            raise ValueError("sources from before threefry draw the "
                             "hashes unshared only")

    out = {}
    k1_lib = ctypes.CDLL(str(build.build_library(
        "quantize", ["quantize.cu"], csrc=csrc)))
    fn = k1_lib["lbt_quantize"]
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def lbt_quantize(*a, fn=fn):
        *head, seed, k1, inner, offset, mode, stream = _no_window_k1(a)
        unshared_hash(k1, inner, mode)
        _no_offset(offset)
        return fn(*head, seed, mode, stream)

    out["quantize_library"] = type("K1", (), {
        "lbt_quantize": staticmethod(lbt_quantize)})
    conv_lib = ctypes.CDLL(str(build.build_library(
        "conv_fused", ["conv_fused.cu"], csrc=csrc)))
    entries = {}
    for name in ("lbt_conv3x3_fused", "lbt_conv1x1_fused"):
        fn = conv_lib[name]
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def entry(*a, fn=fn):
            a = _no_window_conv(a)
            (k0, k1, inner, offset, mode), tail = a[8:13], a[13:]
            unshared_hash(k1, inner, mode)
            _no_offset(offset)
            return fn(*a[:8], k0, int(mode != 0), int(mode == 2), *tail)

        entries[name] = staticmethod(entry)
    out["conv_fused_library"] = type("Fused", (), entries)
    return out


def _k1_cuda_cases(quant, k1, gen, pre_threefry):
    """``(group, label, calls, fn, plain_fn, args, nbytes)`` for every
    K1 training call shape (the hashes' unshared calls only with
    ``pre_threefry``)."""
    exp = torch.tensor(1, dtype=torch.int32, device="cuda")
    for (shape, bits, mode, shared, stats), count in sorted(k1.items()):
        if pre_threefry and (mode == 3 or shared):
            continue
        x = (torch.randn(shape, generator=gen) * 2).cuda()
        noise = cs.noise_of(quant, mode, shape, shared)
        dtype = quant.code_dtype(bits)
        yield ("K1 CUDA train",
               f"{list(shape)} b{bits} {cs.MODE_NAMES[mode]}"
               f"{' shared' if shared else ''}{' mm' if stats else ''}",
               count,
               lambda x, e, bits=bits, noise=noise, stats=stats:
                   quant.quantize_codes(x, bits, e, noise, stats),
               lambda x, e, bits=bits, noise=noise, stats=stats:
                   quant.quantize_codes_plain(x, bits, e, noise, stats),
               (x, exp),
               x.numel() * (4 + torch.empty((), dtype=dtype).element_size()))


def _cases(gemm, fused, serve_k2, k2, tn, conv, gen, pre_threefry):
    """``(group, label, calls, fn, plain_fn, args, nbytes)`` for every
    K2 and #4/#5 call shape (#4/#5's hash calls with an unshared draw
    only with ``pre_threefry``)."""
    inv = torch.tensor([2.0 ** -15], device="cuda")
    for group, calls in (("serve AB", serve_k2), ("train AB", k2)):
        for (m, k, n, scaled), count in sorted(calls.items()):
            args = (_codes((m, k), 128, gen), _codes((k, n), 128, gen))
            args += (inv,) if scaled else ()
            yield (group, f"M{m} K{k} N{n}", count, gemm.int8_matmul,
                   gemm.int8_matmul_plain, args, m * k + k * n + 4 * m * n)
    for (k, m, n), count in sorted(tn.items()):
        yield ("train X^T.g", f"K{k} M{m} N{n}", count, gemm.int8_matmul_tn,
               gemm.int8_matmul_tn_plain,
               (_codes((k, m), 128, gen), _codes((k, n), 128, gen)),
               k * (m + n) + 8 * m * n)
    mult = torch.tensor([2.0 ** -2], device="cuda")
    from lbt_tpu_torch.ops.im2col import out_hw
    from lbt_tpu_torch.ops.kernels import quant
    for key, count in sorted(conv.items()):
        kind, xshape, xdtype, wshape, strides, pads, mode, shared, rbf = key
        if pre_threefry and (mode == 3 or shared):
            continue
        wide = xdtype == str(torch.int16)
        xc = _codes(xshape, 256 if wide else 128, gen,
                    torch.int16 if wide else torch.int8)
        yshape = (xshape[0], *out_hw(xshape[1], xshape[2], wshape[:2],
                                     strides, pads), wshape[3])
        kw = dict(strides=strides, pads=pads, round_bf16=rbf,
                  noise=cs.noise_of(quant, mode, yshape, shared))
        yield (kind, f"x{list(xshape)} w{list(wshape)} s{strides[0]} "
               f"{cs.MODE_NAMES[mode]}{' shared' if shared else ''}", count,
               lambda x, w, fn=getattr(fused, kind), kw=kw: fn(
                   x, w, inv, mult, **kw),
               lambda x, w, kw=kw: fused.conv_fused_plain(x, w, inv, mult,
                                                          **kw),
               (xc, _codes(wshape, 128, gen)),
               xc.numel() * xc.element_size() + xc.shape[0] * wshape[3]
               * xshape[1] * xshape[2] // (strides[0] * strides[1]))


def load_triton_k1(path: Path, build):
    """The module of another version's Triton K1, by file path.  Its
    import asked ``build`` to point Triton's cache into ``_build/``; the
    cache goes there here, whether or not ``build`` still offers that."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(build.BUILD_DIR / "triton"))
    spec = importlib.util.spec_from_file_location("triton_k1", path)
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(build, "use_triton_cache_dir", lambda: None,
                           create=True):
        spec.loader.exec_module(mod)
    return mod


def _k1_cases(quant, old, serve_k1, train_k1, gen):
    """``(group, label, calls, fn, old_fn, site_fn, plain_fn, args,
    nbytes)`` for every K1 call shape: ``fn`` takes the exponent,
    ``old_fn`` the multiplier made beforehand, ``site_fn`` makes it from
    the exponent first, as the old path's ``quantize_int`` did."""
    exp = torch.tensor(1, dtype=torch.int32, device="cuda")
    calls = [("K1 serve", (shape, bits, 0, False, False), n)
             for (shape, bits), n in serve_k1.items()]
    # the Triton K1 drew the hashes only
    calls += [("K1 train", key, n) for key, n in train_k1.items()
              if key[2] in (0, 1, 2) and not key[3]]
    for group, (shape, bits, mode, _, stats), count in sorted(calls):
        x = (torch.randn(shape, generator=gen) * 2).cuda()
        noise = cs.noise_of(quant, mode, shape)
        seed = None if noise is None else noise.k0
        light = mode == 2
        dtype = quant.code_dtype(bits)

        def old_fn(x, e, m, bits=bits, seed=seed, light=light, stats=stats,
                   dtype=dtype):
            codes = torch.empty(x.shape, dtype=dtype, device=x.device)
            minmax = x.new_empty(2) if stats else None
            old.launch(x, m, codes, bits, seed, light, minmax)
            return (codes, minmax) if stats else (codes,)

        def site_fn(x, e, m, old_fn=old_fn, bits=bits):
            return old_fn(x, e, quant.multiplier(bits, e))

        def new_fn(x, e, m, bits=bits, noise=noise, stats=stats):
            return quant.quantize_codes(x, bits, e, noise, stats)

        def plain_fn(x, e, m, bits=bits, noise=noise, stats=stats):
            return quant.quantize_codes_plain(x, bits, e, noise, stats)

        label = (f"{list(shape)} b{bits}{' s' if mode else ''}"
                 f"{' mm' if stats else ''}")
        yield (group, label, count, new_fn, old_fn, site_fn, plain_fn,
               (x, exp, quant.multiplier(bits, exp)),
               x.numel() * (4 + torch.empty((), dtype=dtype).element_size()))


def compare_k1(quant, old, serve_k1, train_k1, gen, rows, totals) -> None:
    """Each K1 call shape: both versions against the plain one (the old
    kernel's codes and min/max; the new one's multiplier too), then timed
    new, old, site, site, old, new."""
    for (group, label, calls, fn, old_fn, site_fn, plain_fn, xs,
         nbytes) in _k1_cases(quant, old, serve_k1, train_k1, gen):
        want = plain_fn(*xs)
        cs.check(_equal(fn(*xs), want), f"{group} {label}: new != plain")
        old_want = (want[0], want[2]) if len(want) == 3 else want[:1]
        cs.check(_equal(old_fn(*xs), old_want),
                 f"{group} {label}: old != plain")
        sets = cs.rotating_inputs(xs, nbytes)
        new_ms = [cs.device_ms(fn, sets)]
        old_ms = [cs.device_ms(old_fn, sets)]
        site_ms = [cs.device_ms(site_fn, sets), cs.device_ms(site_fn, sets)]
        old_ms.append(cs.device_ms(old_fn, sets))
        new_ms.append(cs.device_ms(fn, sets))
        row = {"group": group, "shape": label, "calls": calls,
               "ms": sum(new_ms) / 2, "old_ms": sum(old_ms) / 2,
               "old_site_ms": sum(site_ms) / 2}
        rows.append(row)
        tot = totals[group]
        tot[0] += calls * row["ms"]
        tot[1] += calls * row["old_ms"]
        tot[2] += calls
        tot[3] += calls * row["old_site_ms"]
        print(f"  {group} {label} x{calls}: new {row['ms'] * 1e3:.2f} us, "
              f"old {row['old_ms'] * 1e3:.2f} us (with the multiplier's "
              f"ops {row['old_site_ms'] * 1e3:.2f})", flush=True)


def _equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("csrc", type=Path, help="the other lbt_tpu_torch/csrc")
    ap.add_argument("--pre-threefry", action="store_true",
                    help="the other sources have the C interface from "
                         "before threefry noise")
    ap.add_argument("--pre-window", action="store_true",
                    help="the other sources have the C interface from "
                         "before the noise counter's column window")
    ap.add_argument("--pre-offset", action="store_true",
                    help="the other sources have the C interface from "
                         "before the noise counter's offset")
    ap.add_argument("--pre-rbg", action="store_true",
                    help="the other sources have the C interface from "
                         "before the unsafe_rbg key's noise (mode 4)")
    ap.add_argument("--resnet50", action="store_true",
                    help="the bench headline's ResNet-50 training shapes")
    ap.add_argument("--kernels", default="k1,k2,fused",
                    help="which of k1, k2, fused to compare")
    ap.add_argument("--old-k1", type=Path, default=None,
                    help="the other version's ops/kernels/quant_triton.py")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    kinds = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("compare_csrc: no CUDA device", file=sys.stderr)
        return 1
    qmod, qops, build, gemm, quant = cs.port_modules()
    from lbt_tpu_torch.ops.kernels import conv_fused
    card = cs.phase_device()["nvidia_smi"]
    csrc = args.csrc.resolve()
    old_libs = dict(int8_gemm_library=build.int8_gemm_library(csrc))
    if args.pre_threefry:
        old_libs.update(_behind_rbg(_pre_threefry(build, csrc)))
    elif args.pre_offset:
        old_libs.update(_behind_rbg(_pre_offset(build, csrc)))
    elif args.pre_window:
        old_libs.update(_behind_rbg(_pre_window(build, csrc)))
    elif args.pre_rbg:
        old_libs.update(_pre_rbg(build, csrc))
    else:
        old_libs["conv_fused_library"] = {
            kind: build.conv_fused_library(kind, csrc)
            for kind in build.CONV_FUSED_KINDS}
        if (csrc / "quantize.cu").exists():
            old_libs["quantize_library"] = build.quantize_library(csrc)
    if not isinstance(old_libs["conv_fused_library"], dict):
        old_libs["conv_fused_library"] = _one_library(
            old_libs["conv_fused_library"])
    old = {k: (lambda lib=lib: lib) for k, lib in old_libs.items()}
    old["conv_fused_library"] = (
        lambda kind=0, libs=old_libs["conv_fused_library"]: libs[kind])

    if args.resnet50:
        serve_k1, serve_k2 = {}, {}
        probe = cs.build_resnet50(cs.SEED).to("cuda")
        k1, k2, tn, conv = cs.record_train_calls(
            qmod, qops, quant, gemm, conv_fused, probe,
            cs.r50_batches(1)[0], steps=((0, 1 / 8), (1, 7 / 8)))
        del probe
        torch.cuda.empty_cache()
    else:
        probe = cs.build_resnet20(cs.SEED).to("cuda")
        x = torch.from_numpy(np.random.default_rng(cs.SEED + 3).normal(
            0, 1, (cs.BATCH, 32, 32, 3)).astype(np.float32)).cuda()
        serve_k1, serve_k2 = cs.record_path_calls(probe, x, qmod, qops,
                                                  quant, gemm)
        k1, k2, tn, conv = cs.record_train_calls(qmod, qops, quant, gemm,
                                                 conv_fused)
    rows, totals = [], collections.defaultdict(lambda: [0.0, 0.0, 0, 0.0])
    gen = torch.Generator().manual_seed(cs.SEED + 7)
    if args.old_k1 is not None:
        compare_k1(quant, load_triton_k1(args.old_k1.resolve(), build),
                   serve_k1, k1, gen, rows, totals)
    cases = []
    if "k1" in kinds and "quantize_library" in old_libs:
        cases.append(_k1_cuda_cases(quant, k1, gen, args.pre_threefry))
    cases.append(_cases(
        gemm, conv_fused, serve_k2 if "k2" in kinds else {},
        k2 if "k2" in kinds else {}, tn if "k2" in kinds else {},
        conv if "fused" in kinds else {}, gen, args.pre_threefry))
    for group, label, calls, fn, plain_fn, xs, nbytes in (
            c for group in cases for c in group):
        want = plain_fn(*xs)
        cs.check(_equal(fn(*xs), want), f"{group} {label}: new != plain")
        with mock.patch.multiple(build, **old):
            cs.check(_equal(fn(*xs), want), f"{group} {label}: old != plain")
        sets = cs.rotating_inputs(xs, nbytes)
        new_ms = [cs.device_ms(fn, sets)]
        with mock.patch.multiple(build, **old):
            old_ms = [cs.device_ms(fn, sets), cs.device_ms(fn, sets)]
        new_ms.append(cs.device_ms(fn, sets))
        row = {"group": group, "shape": label, "calls": calls,
               "ms": sum(new_ms) / 2, "old_ms": sum(old_ms) / 2}
        rows.append(row)
        tot = totals[group]
        tot[0] += calls * row["ms"]
        tot[1] += calls * row["old_ms"]
        tot[2] += calls
        print(f"  {group} {label} x{calls:g}: new {row['ms'] * 1e3:.2f} us, "
              f"old {row['old_ms'] * 1e3:.2f} us", flush=True)
    summary = {g: {"ms": t[0], "old_ms": t[1], "calls": t[2],
                   **({"old_site_ms": t[3]} if g in ("K1 serve", "K1 train")
                      else {})}
               for g, t in totals.items()}
    for g, t in summary.items():
        site = (f" ({t['old_site_ms']:.4f} with the multiplier's ops)"
                if "old_site_ms" in t else "")
        print(f"{g}: {t['calls']:g} calls, old {t['old_ms']:.4f} ms{site} "
              f"-> new {t['ms']:.4f} ms ({card})", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "totals": summary,
                                        "shapes": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
