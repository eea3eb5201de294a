"""The benchmark of the PyTorch + CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; see ``bench/README.md``.
"""
