"""Cells cut to a size a CPU test holds: one university of two departments."""
from __future__ import annotations

import copy

from dsbench import harness

TINY = {"uba": {"universities": 1, "departments_per_university": [2, 2]}}


def tiny_cell(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.find_cell(name))
    cell.config.update(TINY[cell.config["generator"]])
    return cell


def run_tiny(name: str, seed: int = 5, seconds: float = 1.5, trace: bool = False, log=None):
    return harness.run_cell(tiny_cell(name), seed, seconds, trace, device="cpu",
                            log=log or (lambda s: None))
