#!/usr/bin/env python3
"""Time K2 and #4/#5 built from another version of their CUDA sources
beside this checkout's, at every call shape of ResNet-20's serving forward
and training step (batch 128), in one run on one CUDA card.

    mkdir -p lbt_tpu_torch/_build/old
    git archive <commit> lbt_tpu_torch/csrc | tar -x -C lbt_tpu_torch/_build/old
    python3 compare_csrc.py lbt_tpu_torch/_build/old/lbt_tpu_torch/csrc \\
        [--out chiprun_out/compare.json]

The other sources must keep the C interface of ``ops/kernels/build.py``.
Each shape is timed as ``chip_smoke.py`` times its kernels (one CUDA graph
replayed over input copies that overflow L2), in turns: new, old, old, new.
Both versions must equal the plain version bitwise.  Prints each shape and
the totals a serving forward and a training step (calls x ms), old and new.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import chip_smoke as cs


def _codes(shape, lim, gen, dtype=torch.int8):
    return torch.randint(-lim, lim, shape, generator=gen, dtype=dtype).cuda()


def _cases(gemm, fused, serve_k2, k2, tn, conv, gen):
    """``(group, label, calls, fn, plain_fn, args, nbytes)`` for every
    K2 and #4/#5 call shape."""
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
    for key, count in sorted(conv.items()):
        kind, xshape, xdtype, wshape, strides, pads, seeded, light = key
        wide = xdtype == str(torch.int16)
        xc = _codes(xshape, 256 if wide else 128, gen,
                    torch.int16 if wide else torch.int8)
        kw = dict(strides=strides, pads=pads, light=light,
                  seed=0x2545F491 if seeded else None)
        yield (kind, f"x{list(xshape)} w{list(wshape)} s{strides[0]}", count,
               lambda x, w, fn=getattr(fused, kind), kw=kw: fn(
                   x, w, inv, mult, **kw),
               lambda x, w, kw=kw: fused.conv_fused_plain(x, w, inv, mult,
                                                          **kw),
               (xc, _codes(wshape, 128, gen)),
               xc.numel() * xc.element_size() + xc.shape[0] * wshape[3]
               * xshape[1] * xshape[2] // (strides[0] * strides[1]))


def _equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("csrc", type=Path, help="the other lbt_tpu_torch/csrc")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_csrc: no CUDA device", file=sys.stderr)
        return 1
    qmod, qops, build, gemm, quant = cs.port_modules()
    from lbt_tpu_torch.ops.kernels import conv_fused
    card = cs.phase_device()["nvidia_smi"]
    old_libs = dict(int8_gemm_library=build.int8_gemm_library(
                        args.csrc.resolve()),
                    conv_fused_library=build.conv_fused_library(
                        args.csrc.resolve()))
    old = {k: (lambda lib=lib: lib) for k, lib in old_libs.items()}

    probe = cs.build_resnet20(cs.SEED).to("cuda")
    x = torch.from_numpy(np.random.default_rng(cs.SEED + 3).normal(
        0, 1, (cs.BATCH, 32, 32, 3)).astype(np.float32)).cuda()
    _, serve_k2 = cs.record_path_calls(probe, x, qmod, qops, quant, gemm)
    _, k2, tn, conv = cs.record_train_calls(qmod, qops, quant, gemm,
                                            conv_fused)
    rows, totals = [], collections.defaultdict(lambda: [0.0, 0.0, 0])
    gen = torch.Generator().manual_seed(cs.SEED + 7)
    for group, label, calls, fn, plain_fn, xs, nbytes in _cases(
            gemm, conv_fused, serve_k2, k2, tn, conv, gen):
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
        print(f"  {group} {label} x{calls}: new {row['ms'] * 1e3:.2f} us, "
              f"old {row['old_ms'] * 1e3:.2f} us", flush=True)
    summary = {g: {"ms": t[0], "old_ms": t[1], "calls": t[2]}
               for g, t in totals.items()}
    for g, t in summary.items():
        print(f"{g}: {t['calls']} calls, old {t['old_ms']:.4f} ms -> new "
              f"{t['ms']:.4f} ms ({card})", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "totals": summary,
                                        "shapes": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
