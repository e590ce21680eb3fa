"""One run of one cell of ``BENCHMARK.json``.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` finds the cell, its configuration
(``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<mix>.json``), its limits
(``portbench/limits/<cell>.json``) and its per-layer metrics
(``portbench/metrics/<metric>.py``) by name, and runs:

1. set-up: the port's ``Trainer`` (:mod:`portbench.program`) with the
   benchmark's seeded weights, the seeded pool of host batches, the
   limits file's first ``steps`` steps through the Trainer's own
   ``train_epoch`` (the readings the reference is held to), then the mix's
   warm-up steps, which run both branches of the controllers' cadence and
   build every kernel;
2. the window: ``train_epoch`` over the pool in a cycle for ``--seconds``,
   steps dispatched back to back, one synchronise at its end; every image
   of every step counts, over the whole window's host time;
3. with ``--trace 1``, a profiled sub-window of whole cadence periods
   (:mod:`portbench.trace`), for the per-layer metrics and the breakdown;
4. the check on ``sys.modules`` (no ``jax``, ``jaxlib``, ``flax`` or
   ``lbt_tpu``, by whole top-level name);
5. the program freed, the plain reference (:mod:`portbench.reference`)
   runs the same steps from the same weights, keys and batches, and the
   numbers of :mod:`portbench.check` decide ``correct``.

The last line of standard output is the result's JSON; the numbers
compared, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict

import torch

from portbench import check, generator
from portbench.reference import resnet
from portbench.yardstick import flops

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lbt_tpu")
GIB = 2 ** 30


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def metric_reader(name: str, here: Path = HERE):
    """The module of per-layer metric ``name``
    (``<here>/metrics/<name>.py``)."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``bench`` (``BENCHMARK.json``'s dict) and its files."""

    def __init__(self, bench: Dict, workload: str, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.cfg = load_json(here.parent / configs[self.entry["config"]]
                             ["file"])
        self.mix = generator.load(here / "traffic"
                                  / f"{self.entry['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.here = here
        self.spec = resnet.Spec.from_config(self.cfg)


def key_seed(seed: int) -> int:
    """The stochastic rounding's key seed (below 2**31) of a run seed."""
    return seed % (2 ** 31)


def initial_params(cell: Cell, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return resnet.init_params(cell.spec, gen, device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def set_up(cell: Cell, seed: int, device, faults=None):
    """The program built from ``seed`` and driven through the cell's
    compared steps: ``(program, pool, its readings)``.  ``faults`` (the
    tests' planted faults) is called with the
    :class:`~portbench.program.Program` once its weights are loaded and
    before its first step, and may break the timed path underneath."""
    from portbench import program as prog_mod
    dev = torch.device(device)
    mix, steps = cell.mix, cell.limits["steps"]
    if steps > mix["pool_batches"] or steps > mix["warmup_steps"]:
        raise ValueError("the compared steps need their own batches and "
                         "fall within the warm-up")
    pool = generator.pool(mix, cell.spec.image_size, cell.spec.num_classes,
                          seed + 1, dev)
    params0 = initial_params(cell, seed, dev)
    prog = prog_mod.Program(cell.cfg, mix["batch_size"], key_seed(seed),
                            mix["start_step"], dev)
    prog.load(params0)
    if faults is not None:
        faults(prog)
    # one train_epoch a step, read as it ends
    with prog.losses() as got:
        for i in range(steps):
            prog.run(generator.first(pool, 1, i))
            if i == 0:
                grad1 = check.norms(prog.velocity())
        losses = torch.stack(got).cpu().tolist()
    bn0 = {k: torch.zeros_like(v) if k.endswith(".mean")
           else torch.ones_like(v) for k, v in prog.bn_stats().items()}
    read = {"loss": losses, "grad": grad1,
            "change": check.norms(prog.params(), params0),
            "bn": check.norms(prog.bn_stats(), bn0),
            "exps": prog.exponents()}
    return prog, pool, read


def reference_readings(cell: Cell, seed: int, pool, device, spec=None,
                       rows=None) -> Dict:
    """The reference's readings of the cell's compared steps from the same
    weights, keys and batches (``spec`` in place of the cell's; ``rows``:
    only the first rows of each batch)."""
    dev = torch.device(device)
    spec = spec or cell.spec
    ref = resnet.Reference(spec, initial_params(cell, seed, dev),
                           key_seed(seed))
    p0 = {k: v.detach().clone() for k, v in ref.params.items()}
    b0 = {k: v.clone() for k, v in ref.buffers.items()}
    losses = []
    for i in range(cell.limits["steps"]):
        x, y = (torch.from_numpy(a[:rows]).to(dev) for a in pool[i])
        losses.append(ref.step(x, y, cell.mix["start_step"] + i))
        if i == 0:
            grad1 = check.norms(ref.velocity)
    return {"loss": losses, "grad": grad1,
            "change": check.norms(ref.params, p0),
            "bn": check.norms(ref.buffers, b0), "exps": ref.exponents()}


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, faults=None) -> Dict:
    """One run on ``device``; returns the result's fields and the compared
    numbers (``faults`` as :func:`set_up`'s)."""
    from portbench import program as prog_mod
    from portbench import trace as trace_mod

    dev = torch.device(device)
    mix = cell.mix
    prog, pool, prog_read = set_up(cell, seed, dev, faults)
    prog.run(generator.first(pool, mix["warmup_steps"]
                             - cell.limits["steps"], cell.limits["steps"]))
    _sync(dev)
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
    setup_s = time.perf_counter() - t0

    # the window
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first_step = prog.trainer.step
    tw = time.perf_counter()
    ep = prog.run(generator.timed(pool, seconds))
    window_s = time.perf_counter() - tw
    n_steps = prog.trainer.step - first_step
    window = {"seconds": window_s, "steps": n_steps,
              "images": ep["images"], "stall_seconds": ep["stall_seconds"]}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    rec = {"window": window,
           "train_ops_per_image": flops.train_ops_per_image(cell.spec),
           "peak_ops_per_s": flops.peak_ops_per_s(cell.spec)}
    if trace:
        n_prof = generator.profile_steps(
            mix, cell.cfg["quant"]["range_update_every"])
        prof = {"steps": n_prof}
        before = prog_mod.counters()
        with prog_mod.recorded_calls() as calls, \
                trace_mod.profiled(prof, lambda: _sync(dev)):
            prog.run(generator.first(pool, n_prof))
        prof["calls"] = dict(calls)
        prof["counters"] = {k: v - before[k]
                            for k, v in prog_mod.counters().items()}
        rec["profile"] = prof
    found = forbidden_modules()
    del prog
    free(dev)

    t_ref = time.perf_counter()
    nums = check.numbers(prog_read, reference_readings(cell, seed, pool, dev))
    t_ref = time.perf_counter() - t_ref
    limits = cell.limits["limits"]
    return {"correct": check.judge(nums, limits) and not found,
            "forbidden": found, "attempted": n_steps, "failed": 0,
            "setup_s": setup_s, "setup_peak": setup_peak, "peak": peak,
            "window": window, "record": rec, "numbers": nums,
            "limits": limits, "reference_s": t_ref}


def result_line(cell: Cell, res: Dict, trace: bool, device_name: str,
                chips: int) -> Dict:
    """The result's JSON: end-to-end metrics with ``--trace 0``, the
    cell's per-layer metrics with ``--trace 1``; the compared numbers
    last."""
    metrics, out = {}, {}
    if not trace:
        w = res["window"]
        values = {"setup_s": res["setup_s"],
                  "train_img_s": w["images"] / w["seconds"],
                  "train_peak_gib": res["peak"] / GIB}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = metric_reader(m["name"], cell.here).read(res["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": chips,
              "memory_peak_bytes": max(res["peak"], res["setup_peak"])}
    if trace:
        from portbench import trace as trace_mod
        p = res["record"]["profile"]
        device["busy_s"] = trace_mod.busy_s(p)
        device["window_s"] = p["wall_s"]
        out["breakdown"] = {"device_ops": trace_mod.device_ops(p),
                            "idle_gaps": trace_mod.idle_gaps(p)}
    nums = res["numbers"]
    return {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device,
            **out,
            "checks": {k: {"value": nums[k]["value"], "limit": v}
                       for k, v in res["limits"].items()}}


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    if args.seed < 0:
        print("portbench: --seed must be a whole number >= 0",
              file=sys.stderr)
        return 2
    cell = Cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    chips = int(cell.entry["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 3
    from portbench import program
    if not Path(program.PACKAGE_FILE).resolve().is_relative_to(ROOT):
        print(f"portbench: lbt_tpu_torch imported from "
              f"{program.PACKAGE_FILE}, outside the checkout {ROOT}",
              file=sys.stderr)
        return 4
    torch.set_num_threads(1)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t0)
    found = sorted(set(res["forbidden"]) | set(forbidden_modules()))
    if found:
        print(f"portbench: modules loaded that the run may not load: "
              f"{found}", file=sys.stderr)
        return 5
    line = result_line(cell, res, bool(args.trace),
                       torch.cuda.get_device_name(0), chips)
    nums = res["numbers"]
    print(f"portbench: {args.workload} seed {args.seed}: "
          f"{res['attempted']} steps in {res['window']['seconds']:.3f} s, "
          f"set-up {res['setup_s']:.3f} s, reference {res['reference_s']:.3f}"
          f" s; exponents differing from the reference: "
          f"{nums['exps_differ']}",
          file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    for s in check.lines(nums, res["limits"]):
        print(s, file=sys.stderr)
    return 0
