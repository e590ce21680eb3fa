#!/usr/bin/env python3
"""Smoke run of lbt_tpu_torch on one NVIDIA GPU: serve DFXP-INT8 ResNet-20.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--out details.json]

Phases; each raises on failure and the script then exits non-zero:

1. device  needs CUDA; prints the card's name and power limit; TF32 off.
2. build   builds K2 (nvcc, sm_90a) and compiles K1 (Triton) from the
           sources in the checkout; prints the seconds each took.
3. K1      quantize kernel vs its plain PyTorch version on the card,
           bitwise, at every quantize shape of the serving path (batch
           128) and at odd sizes; bits 8 and 9; deterministic and both
           counter-hash stochastic modes.
4. K2      int8 GEMM vs its plain version, bitwise, at every GEMM shape
           of the serving path (each conv's im2col product, the head).
           K1 and K2 are timed per shape from CUDA graphs that rotate
           over enough input copies to overflow the L2 cache, so their
           operands come from device memory (see ``device_ms``).
5. serve   CIFAR10_Resnet20 under QuantConfig.uniform(8), random weights
           from a seed, on the card.  A Predictor answers 8 requests of
           128 images with every launch counter reset just before; each
           kernel must have launched.  Logits must match the same weights
           served on the CPU (plain route) at rtol = atol = 1e-5, with
           equal labels.  Times the kernel route against the plain route
           on the card (in turns), each kernel against its plain version
           at the path's shapes, and takes a profiler window that also
           gives each kernel's device time as the serving path runs it.

Prints one JSON line of kernels, then, last, one JSON line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 128
N_REQUESTS = 8
SEED = 0
TOL = dict(rtol=1e-5, atol=1e-5)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rotating_inputs(args, nbytes: int, max_copies: int = 64) -> list:
    """Device copies of ``args`` (tensors), enough that calls cycling
    over them touch at least four times the L2 cache (``nbytes`` = bytes
    one call reads and writes) before a copy comes round again; at most
    ``max_copies``, so the smallest shapes stay L2-resident."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    n = max(1, min(max_copies, math.ceil(4 * l2 / nbytes)))
    return [tuple(a.clone() for a in args) for _ in range(n)]


def eager_ms(fn, sets, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn(*set)`` launched eagerly from the host,
    cycling over the input ``sets``, in ms (CUDA events around the
    calls): device time plus whatever launch gaps the host leaves."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    n = max(reps, len(sets))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, sets, reps: int = 20, replays: int = 5) -> float:
    """Mean device time per call of ``fn(*set)`` in ms: calls cycling
    over the input ``sets`` captured in one CUDA graph and replayed, so
    host launch cost drops out, and (by :func:`rotating_inputs`) the
    operands of each call were last touched four L2 sizes earlier."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    n = max(reps, len(sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*sets[i % len(sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def _timings(fn, plain_fn, args, nbytes: int) -> dict:
    sets = rotating_inputs(args, nbytes)
    return {"ms": device_ms(fn, sets), "plain_ms": device_ms(plain_fn, sets),
            "eager_ms": eager_ms(fn, sets),
            "plain_eager_ms": eager_ms(plain_fn, sets),
            "input_copies": len(sets)}


def _per_forward(rows) -> dict:
    return {k: sum(r["calls"] * r[k] for r in rows)
            for k in ("ms", "plain_ms", "eager_ms", "plain_eager_ms")}


def phase_device() -> dict:
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"nvidia_smi": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build(quant, gemm, build) -> dict:
    t0 = time.perf_counter()
    build.int8_gemm_library()
    k2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.zeros(4, device="cuda")
    mult = torch.ones((), device="cuda")
    for bits in (8, 9):
        for seed, light in ((None, False), (1, False), (1, True)):
            quant.quantize_codes(x, bits, mult, seed, light)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - t0
    print(f"build: K2 nvcc {k2_s:.1f} s, K1 triton {k1_s:.1f} s", flush=True)
    return {"k2_nvcc_s": k2_s, "k1_triton_s": k1_s}


def record_path_calls(model, x, qmod, qops, quant, gemm):
    """Count the (shape, bits) of every K1 call and the (M, K, N, scaled)
    of every K2 call that one forward of ``model`` on ``x`` makes."""
    from lbt_tpu_torch.nn.core import Ctx
    k1, k2 = collections.Counter(), collections.Counter()

    def k1_rec(t, bits, mult, seed=None, light=False):
        k1[(tuple(t.shape), bits)] += 1
        return quant.quantize_codes(t, bits, mult, seed, light)

    def k2_rec(a, b, inv=None):
        k2[(a.shape[0], a.shape[1], b.shape[1], inv is not None)] += 1
        return gemm.int8_matmul(a, b, inv)

    with mock.patch.object(qmod, "quantize_codes", k1_rec), \
            mock.patch.object(qops, "int8_matmul", k2_rec), \
            torch.inference_mode():
        model.apply(x, Ctx(train=False, update=False))
    return k1, k2


def _k1_input(shape, bits, gen):
    from lbt_tpu_torch.dfxp.quantize import multiplier
    mult = multiplier(bits, 2)
    x = torch.randn(shape, generator=gen) * 2
    ties = torch.tensor([0.5, -0.5, 2.5, -3.5, 1e9, -1e9]) / mult
    n = min(x.numel(), ties.numel())
    x.view(-1)[:n] = ties[:n]
    return x.cuda(), mult.cuda()


def phase_k1(quant, k1_calls) -> dict:
    gen = torch.Generator().manual_seed(SEED + 1)
    shapes = {s for s, _ in k1_calls}
    shapes |= {(1,), (4097,), (3, 5, 7), (BATCH, 32, 32, 16)}
    err, n_cmp = 0.0, 0
    for shape in sorted(shapes):
        for bits in (8, 9):
            x, mult = _k1_input(shape, bits, gen)
            for seed, light in ((None, False), (0x9E3779B9, False),
                                (0x2545F491, True)):
                got = quant.quantize_codes(x, bits, mult, seed, light)
                want = quant.quantize_codes_plain(x, bits, mult, seed, light)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype,
                      f"K1 dtype {got.dtype} != {want.dtype}")
                d = (got.to(torch.float64) - want.to(torch.float64)).abs()
                err = max(err, d.max().item() if d.numel() else 0.0)
                check(torch.equal(got, want),
                      f"K1 differs from its plain version at {shape} "
                      f"bits={bits} seed={seed} light={light}")
                n_cmp += 1
    rows = []
    for (shape, bits), count in sorted(k1_calls.items()):
        x, mult = _k1_input(shape, bits, gen)
        code_bytes = torch.empty((), dtype=quant.code_dtype(bits)).element_size()
        rows.append({"shape": list(shape), "bits": bits, "calls": count,
                     **_timings(
                         lambda x, m: quant.quantize_codes(x, bits, m),
                         lambda x, m: quant.quantize_codes_plain(x, bits, m),
                         (x, mult), x.numel() * (4 + code_bytes))})
    for r in rows:
        print(f"  K1 {r['shape']} bits {r['bits']} x{r['calls']}: device "
              f"{r['ms'] * 1e3:.1f} us (plain {r['plain_ms'] * 1e3:.1f})")
    tot = _per_forward(rows)
    print(f"K1: {n_cmp} comparisons bitwise equal; per forward, device "
          f"{tot['ms']:.4f} ms (plain {tot['plain_ms']:.4f}), launched "
          f"eagerly {tot['eager_ms']:.4f} ms (plain "
          f"{tot['plain_eager_ms']:.4f})", flush=True)
    return {"max_abs_err": err, "comparisons": n_cmp, **tot, "shapes": rows}


def phase_k2(gemm, k2_calls) -> dict:
    gen = torch.Generator().manual_seed(SEED + 2)
    err, rows = 0.0, []
    for (m, k, n, scaled), count in sorted(k2_calls.items()):
        a = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        b = torch.randint(-128, 128, (k, n), generator=gen,
                          dtype=torch.int8).cuda()
        inv = torch.tensor([2.0 ** -15], device="cuda")
        for s in (None, inv):
            got = gemm.int8_matmul(a, b, s)
            want = gemm.int8_matmul_plain(a, b, s)
            torch.cuda.synchronize()
            d = (got.to(torch.float64) - want.to(torch.float64)).abs()
            err = max(err, d.max().item())
            check(torch.equal(got, want),
                  f"K2 differs from its plain version at M={m} K={k} N={n} "
                  f"scaled={s is not None}")
        args = (a, b, inv) if scaled else (a, b)
        nbytes = m * k + k * n + m * n * 4
        row = {"m": m, "k": k, "n": n, "scaled": scaled, "calls": count,
               **_timings(gemm.int8_matmul, gemm.int8_matmul_plain, args,
                          nbytes)}
        row["int8_tops"] = 2 * m * k * n / row["ms"] / 1e9
        row["gb_per_s"] = nbytes / row["ms"] / 1e6
        rows.append(row)
    for r in rows:
        print(f"  K2 [{r['m']},{r['k']}]x[{r['k']},{r['n']}] "
              f"{'f32' if r['scaled'] else 'i32'} x{r['calls']}: device "
              f"{r['ms'] * 1e3:.1f} us (plain {r['plain_ms'] * 1e3:.1f}), "
              f"{r['gb_per_s']:.0f} GB/s")
    tot = _per_forward(rows)
    print(f"K2: {len(rows)} path shapes bitwise equal; per forward, device "
          f"{tot['ms']:.4f} ms (plain {tot['plain_ms']:.4f}), launched "
          f"eagerly {tot['eager_ms']:.4f} ms (plain "
          f"{tot['plain_eager_ms']:.4f})", flush=True)
    return {"max_abs_err": err, **tot, "shapes": rows}


@contextlib.contextmanager
def plain_route(qmod, qops, quant, gemm):
    """Send the serving path through the plain versions of K1 and K2 on
    the card (for timing and cross-checking the kernel route only)."""
    with mock.patch.object(qmod, "quantize_codes",
                           quant.quantize_codes_plain), \
            mock.patch.object(qops, "int8_matmul", gemm.int8_matmul_plain):
        yield


def build_resnet20(seed: int):
    """CIFAR10_Resnet20 at uniform(8) with random weights from ``seed``;
    BN running statistics, gamma and beta randomized too, so every BN
    does real work."""
    from lbt_tpu_torch.config import QuantConfig
    from lbt_tpu_torch.models import build_model
    from lbt_tpu_torch.nn.norm import Normalization, Rescale
    gen = torch.Generator().manual_seed(seed)
    model = build_model("CIFAR10_Resnet20", QuantConfig.uniform(8))
    model.init(gen)
    with torch.no_grad():
        for layer in model.net.modules():
            if isinstance(layer, Normalization):
                layer.mean.normal_(0.0, 0.5, generator=gen)
                layer.var.uniform_(0.5, 2.0, generator=gen)
            elif isinstance(layer, Rescale):
                layer.gamma.uniform_(0.5, 1.5, generator=gen)
                layer.beta.normal_(0.0, 0.3, generator=gen)
    return model


def phase_serve(quant, gemm, qmod, qops) -> dict:
    from lbt_tpu_torch.infer import Predictor
    from lbt_tpu_torch.nn.core import Ctx
    ctx = Ctx(train=False, update=False)
    rng = np.random.default_rng(SEED)
    requests = [rng.normal(0, 1, (BATCH, 32, 32, 3)).astype(np.float32)
                for _ in range(N_REQUESTS)]
    card_model = build_resnet20(SEED)
    cpu_model = build_resnet20(SEED)
    predictor = Predictor(card_model, device="cuda")
    predictor(requests[0])  # warm-up, before the counted run
    torch.cuda.synchronize()

    quant.quantize_codes.launches = 0
    gemm.int8_matmul.launches = 0
    labels = [predictor(x).cpu() for x in requests]
    torch.cuda.synchronize()
    launches = {"k1": quant.quantize_codes.launches,
                "k2": gemm.int8_matmul.launches}
    print(f"serve: {N_REQUESTS} requests of {BATCH}; launches {launches}",
          flush=True)
    check(launches["k1"] > 0, "K1 never launched on the serving path")
    check(launches["k2"] > 0, "K2 never launched on the serving path")

    err = 0.0
    with torch.inference_mode():
        for x, lab in zip(requests, labels):
            want = cpu_model.apply(torch.from_numpy(x), ctx)
            got = card_model.apply(torch.from_numpy(x).cuda(), ctx).cpu()
            check(got.shape == (BATCH, 10) and bool(torch.isfinite(got)
                                                    .all()),
                  f"bad logits {tuple(got.shape)}")
            err = max(err, (got - want).abs().max().item())
            check(torch.allclose(got, want, **TOL),
                  f"card logits differ from the CPU route: max abs "
                  f"{(got - want).abs().max().item():.3g}")
            check(torch.equal(lab, want.argmax(-1)),
                  "card labels differ from the CPU route")
            with plain_route(qmod, qops, quant, gemm):
                plain = card_model.apply(torch.from_numpy(x).cuda(), ctx)
            check(torch.equal(plain.cpu(), got),
                  "plain route on the card differs from the kernel route")
    print(f"serve: logits match the CPU route (max abs err {err:.3g})",
          flush=True)

    def timed(route: str):
        before = (quant.quantize_codes.launches, gemm.int8_matmul.launches)
        times = []
        with (plain_route(qmod, qops, quant, gemm) if route == "plain"
              else contextlib.nullcontext()):
            predictor(requests[0])
            torch.cuda.synchronize()
            for x in requests:
                t0 = time.perf_counter()
                predictor(x).cpu()
                times.append((time.perf_counter() - t0) * 1e3)
        after = (quant.quantize_codes.launches, gemm.int8_matmul.launches)
        check((after == before) == (route == "plain"),
              f"{route} route launched kernels {before} -> {after}")
        return times

    samples = {"kernel": [], "plain": []}
    for route in ("plain", "kernel", "kernel", "plain") * 2:
        samples[route] += timed(route)
    med = {r: statistics.median(v) for r, v in samples.items()}
    print(f"serve: median ms per request of {BATCH}: kernel route "
          f"{med['kernel']:.3f}, plain route {med['plain']:.3f}",
          flush=True)
    return {"launches": launches, "logits_max_abs_err": err,
            "ms_per_request": med, "samples_ms": samples,
            "requests": N_REQUESTS, "batch": BATCH}


def phase_profile(predictor, x) -> dict:
    """Device time by kernel over two requests, the device's busy share
    of that window, and K1's and K2's device ms per request as the path
    runs them, on operands the path just wrote (None where the profiler
    saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    predictor(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            predictor(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [{"name": ev.key[:90], "calls": ev.count,
             "device_ms": ev.self_device_time_total / 1e3}
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows) if rows else None
    in_path = {k: sum(r["device_ms"] for r in rows if name in r["name"])
               / 2 if rows else None
               for k, name in (("k1", "_quant_kernel"),
                               ("k2", "int8_gemm_kernel"))}
    out = {"wall_ms": wall_ms, "device_ms": busy,
           "busy_share": busy / wall_ms if rows else None,
           "launches_per_request": sum(r["calls"] for r in rows) / 2,
           "kernel_ms_per_request": in_path, "top": rows[:15]}
    print(f"profile: 2 requests, wall {wall_ms:.2f} ms, device kernels "
          f"{busy} ms; per request in the path, K1 {in_path['k1']} ms, "
          f"K2 {in_path['k2']} ms", flush=True)
    return out


def port_modules():
    """Import every module of the port that this script drives and check
    that none of them loaded JAX, which the card's machine does not have
    (the port's config comes from ``lbt_tpu.config``, so
    ``lbt_tpu/__init__.py`` runs too).  Returns the modules the phases
    take."""
    import lbt_tpu_torch.config  # noqa: F401
    import lbt_tpu_torch.infer  # noqa: F401
    import lbt_tpu_torch.models  # noqa: F401
    import lbt_tpu_torch.nn.core  # noqa: F401
    import lbt_tpu_torch.nn.norm  # noqa: F401
    from lbt_tpu_torch.dfxp import quantize as qmod
    from lbt_tpu_torch.ops import qops
    from lbt_tpu_torch.ops.kernels import build, gemm, quant
    check("jax" not in sys.modules, "importing lbt_tpu_torch loaded jax")
    return qmod, qops, build, gemm, quant


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "lbt_tpu_torch").is_dir():
        print(f"chip_smoke: no lbt_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    qmod, qops, build, gemm, quant = port_modules()

    report = {"device": phase_device()}
    report["build"] = phase_build(quant, gemm, build)
    probe = build_resnet20(SEED).to("cuda")
    x = torch.from_numpy(np.random.default_rng(SEED + 3).normal(
        0, 1, (BATCH, 32, 32, 3)).astype(np.float32)).cuda()
    k1_calls, k2_calls = record_path_calls(probe, x, qmod, qops, quant,
                                           gemm)
    report["k1"] = phase_k1(quant, k1_calls)
    report["k2"] = phase_k2(gemm, k2_calls)
    report["serve"] = phase_serve(quant, gemm, qmod, qops)
    from lbt_tpu_torch.infer import Predictor
    report["profile"] = phase_profile(Predictor(probe), x)

    kernels = [
        {"name": "k1_quantize", "route": "triton",
         "source": "lbt_tpu_torch/ops/kernels/quant_triton.py",
         "replaces": "lbt_tpu/ops/pallas/quant_kernels.py:126",
         "launches": report["serve"]["launches"]["k1"],
         "max_abs_err": report["k1"]["max_abs_err"],
         "ms": report["k1"]["ms"], "plain_ms": report["k1"]["plain_ms"]},
        {"name": "k2_int8_gemm", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/int8_gemm.cu",
         "replaces": "lbt_tpu/ops/pallas/quant_kernels.py:187",
         "launches": report["serve"]["launches"]["k2"],
         "max_abs_err": report["k2"]["max_abs_err"],
         "ms": report["k2"]["ms"], "plain_ms": report["k2"]["plain_ms"]},
    ]
    report["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": report["device"]["kind"],
        "count": report["device"]["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
