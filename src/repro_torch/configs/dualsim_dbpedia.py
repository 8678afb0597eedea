"""Paper workload: DBpedia (751M triples, 65430 predicates, 216M nodes).
High-selectivity predicates: a 5-edge query touches ~2M edges/operator."""
from .dualsim_base import DualsimArch, DualsimScale

SPEC = DualsimArch(
    "dualsim-dbpedia",
    DualsimScale(
        n_nodes=216_132_665,
        edges_per_mat=(2_000_000,) * 10,  # 5 predicates x fwd/bwd
        n_vars=5,
        n_ineqs=10,
    ),
    batch16_nodes=216_132_665,
)
