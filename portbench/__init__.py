"""The benchmark of the PyTorch / CUDA port (``sentinel_tpu_torch``).

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints its result as the last line of standard output. See
``harness.py`` for what a run does and ``PERF.md`` at the root of the
repository for the cells, the metrics and how ``correct`` is decided.
"""
