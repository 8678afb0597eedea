"""Benchmark of the PyTorch/CUDA dual-simulation engine (``repro_torch``).

``python dsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on one card and prints one JSON
line.  Everything a cell needs is found by name: its configuration under
``configs/``, its traffic mix under ``traffic/``, its check settings under
``workloads/``, each metric's reader under ``metrics/``, and each data
generator under ``data/``.  ``reference/`` is the plain NumPy dual
simulation the answers are judged against; it imports nothing of the
program.
"""
