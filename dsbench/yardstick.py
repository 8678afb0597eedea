"""Frozen arithmetic the metrics are computed with.

Each piece is a copy, kept here so that a change to the program cannot move
the yardstick:

* the percentiles over raw samples: ``chip_smoke.py``'s serving phase
  (``statistics.median`` and ``statistics.quantiles(..., n=100,
  method="inclusive")``);
* the H100's memory rate: ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, NVIDIA's
  data sheet for the H100 SXM (3.35 TB/s);
* K1's kernels by the names a profiler trace gives them, and the least
  bytes one call moves: ``chip_smoke.py``'s ``SEGOR_KERNELS`` and
  ``time_segor`` (edge ids 8 bytes an edge, the packed frontier read once
  and the packed output written once), counted here from the query and the
  data rather than from the padded layout.
"""
from __future__ import annotations

import math
import statistics

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
SEGOR_KERNELS = ("Memset", "transpose_kernel", "segor_blocks_kernel")
WORD_BITS = 32


def percentile(values: list[float], q: int) -> float:
    """The ``q``-th percentile (1-99) of raw samples; a missing sample is
    ``inf``, and a percentile that reaches one is ``inf``."""
    if not values:
        return math.nan
    if q == 50:
        v = statistics.median(values)
    elif len(values) == 1:
        v = values[0]
    else:
        v = statistics.quantiles(values, n=100, method="inclusive")[q - 1]
    return math.inf if math.isnan(v) else v


def k1_call_bytes(n_vars: int, n_nodes: int, label_edges: int) -> int:
    """Least bytes one K1 call of one operator moves: its label's edges (a
    source and a destination id, 4 bytes each) and the packed ``[V, nw]``
    frontier read once and output written once."""
    nw = -(-n_nodes // WORD_BITS)
    return 8 * label_edges + 2 * n_vars * nw * 4


def k1_microbatch_bytes(sweeps: int, n_vars: int, n_nodes: int,
                        label_edges: list[int]) -> int:
    """Least bytes of one microbatch's fixpoint: every sweep applies a
    forward and a backward operator per label of the query."""
    return sweeps * sum(2 * k1_call_bytes(n_vars, n_nodes, e) for e in label_edges)
