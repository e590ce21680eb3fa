"""The readings that the limits of ``correct`` are set from (run on the
card at the cell's own size; not part of a benchmark run):

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \\
        [--control] [--half] [--out FILE]

For each seed: the program's compared steps against the reference's
(``sound``); with ``--control``, the control against the reference: the
reference itself in the program's place at the nearest precision below
the configuration's, 4-bit codes for its 8-bit ones; with ``--half``,
the fault "half of the batch left out, the mean taken over the rest":
the reference on the first half of each batch against the reference.  A
state left unchanged reads 1 by ``grad`` and ``change`` and needs no run.
One JSON line a seed and kind.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402
from portbench.reference import resnet  # noqa: E402


def seed_readings(cell, seed, device, control, half, fh=None):
    t0 = time.perf_counter()
    dev = torch.device(device)
    prog, pool, got = harness.set_up(cell, seed, dev)
    del prog
    harness.free(dev)
    want = harness.reference_readings(cell, seed, pool, dev)
    rows = [("sound", got)]
    if control:
        low = resnet.Spec.from_config(cell.cfg, bits_w=4, bits_a=4,
                                      bits_b=4, bits_g=4)
        rows.append(("control", harness.reference_readings(
            cell, seed, pool, dev, spec=low)))
    if half:
        rows.append(("half_batch", harness.reference_readings(
            cell, seed, pool, dev, rows=cell.mix["batch_size"] // 2)))
    out = []
    for kind, r in rows:
        nums = check.numbers(r, want)
        line = {"workload": cell.name, "seed": seed, "kind": kind,
                "numbers": {k: nums[k]["value"] for k in check.NUMBERS},
                "worst": {k: nums[k]["leaf"] for k in check.NUMBERS},
                "exps_differ": nums["exps_differ"],
                "loss": r["loss"], "ref_loss": want["loss"],
                "seconds": time.perf_counter() - t0}
        out.append(line)
        print(json.dumps(line), flush=True)
        if fh is not None:
            fh.write(json.dumps(line) + "\n")
            fh.flush()
    return out


def main(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--half", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        args.workload)
    fh = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            seed_readings(cell, seed, args.device, args.control, args.half,
                          fh)
    finally:
        if fh is not None:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
