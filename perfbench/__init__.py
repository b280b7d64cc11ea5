"""The benchmark of the PyTorch and CUDA port (``satellite_computervision_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. See ``PERF.md`` at the root of
the repository for the cells, the metrics and how ``correct`` is decided.
"""
