"""Run one cell of ``BENCHMARK.json`` on this machine's card(s):

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``lbt_tpu_torch`` beside
``portbench``.  Every cache the run writes stays inside the checkout, in
``.portbench_cache/``.  Exits non-zero, printing no result, without
enough CUDA devices or without the port.  See ``portbench/harness.py``.
"""

import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process with few threads: the host's intra-op pools stay at one
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[0] = str(ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
