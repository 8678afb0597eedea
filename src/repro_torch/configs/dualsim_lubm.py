"""Paper workload: LUBM (1.38B triples, 18 predicates, 329M nodes).
Query shape mirrors L1 (6 pattern edges -> 12 inequality operators over 6
low-selectivity predicates; ~77M edges per operator direction)."""
from .dualsim_base import DualsimArch, DualsimScale

SPEC = DualsimArch(
    "dualsim-lubm",
    DualsimScale(
        n_nodes=328_620_750,
        edges_per_mat=(77_000_000,) * 12,  # 6 predicates x fwd/bwd
        n_vars=6,
        n_ineqs=12,
    ),
    batch16_nodes=328_620_750,
)
