"""The benchmark of ``lbt_tpu_torch`` on one NVIDIA H100: ``run.py`` runs
one cell of ``BENCHMARK.json`` (``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``)."""
