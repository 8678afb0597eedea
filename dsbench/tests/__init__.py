"""CPU tests of the benchmark; card-only tests are marked ``gpu``.

Run from the repository root: ``python -m pytest dsbench/tests -q``.
"""
