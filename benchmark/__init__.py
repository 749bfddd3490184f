"""The benchmark of gpuseqalign_tpu_torch: one cell of BENCHMARK.json a run.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Everything that belongs to one
configuration, traffic mix, entry or metric lives in a file of its own
(``configs/``, ``traffic/``, ``entries/``, ``metrics/``), found by the name
``BENCHMARK.json`` gives it.
"""
