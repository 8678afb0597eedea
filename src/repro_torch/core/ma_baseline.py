"""Ma et al. (2014) dual-simulation algorithm — the paper's Table-2 rival.

The "single passive strategy" (paper Sect. 1/3): start from the full
candidate relation and repeatedly re-check the *definition* (Def. 2) for
every pattern node / candidate pair, removing violating pairs, until a full
pass makes no change.  Candidate tests walk adjacency lists per pair, which
is what gives the naive O(|V2|^3) behaviour the SOI formulation avoids
in practice (fewer, cheaper iterations).

Implemented in numpy with per-pair CSR scans to stay faithful to the
original evaluation strategy (vectorizing the inner test would silently turn
it into our algorithm).
"""
from __future__ import annotations

import numpy as np

from .graph import Graph


def dual_simulation_ma(pattern: Graph, db: Graph) -> tuple[np.ndarray, int]:
    """Largest dual simulation via Ma et al.'s refinement.

    Returns (S bool[|V1|, |V2|], number of full passes).
    """
    n1, n2 = pattern.n_nodes, db.n_nodes
    sim = np.ones((n1, n2), dtype=bool)

    # pre-index pattern edges per node
    p_out = [[] for _ in range(n1)]  # (label, w)
    p_in = [[] for _ in range(n1)]  # (label, u)
    for s, a, o in pattern.triples:
        p_out[s].append((a, o))
        p_in[o].append((a, s))

    passes = 0
    changed = True
    while changed:
        changed = False
        passes += 1
        for v in range(n1):
            for x in np.flatnonzero(sim[v]):
                ok = True
                # Def. 2(i): every outgoing pattern edge must be matched.
                for a, w in p_out[v]:
                    succ = db.fwd(a, int(x))
                    if len(succ) == 0 or not sim[w, succ].any():
                        ok = False
                        break
                if ok:
                    # Def. 2(ii): every incoming pattern edge must be matched.
                    for a, u in p_in[v]:
                        pred = db.bwd(a, int(x))
                        if len(pred) == 0 or not sim[u, pred].any():
                            ok = False
                            break
                if not ok:
                    sim[v, x] = False
                    changed = True
    return sim, passes
