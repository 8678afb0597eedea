"""K1's share of its roofline over the traced window: the least time the
bytes of every K1 call need at the card's memory rate, over the device time
of K1's kernels.

The bytes are counted from the query and the data (``dsbench.yardstick``):
for each microbatch the fixpoint solved on an edge engine, its sweeps times
a forward and a backward operator per label of the query, each the label's
edges at 8 bytes and the packed ``[rows x variables, nodes / 32]`` frontier
read once and written once.  The rows are the microbatch's distinct
constant sets (its riders' distinct query texts), not the padded bucket it
ran in; the variables are the reference's SOI's."""
from dsbench.yardstick import HBM_BYTES_PER_S, SEGOR_KERNELS, k1_microbatch_bytes

EDGE_ENGINES = ("sparse", "jacobi_packed")


def read(run):
    s = run.summary
    if s is None:
        return None
    k1_s = sum(v for k, v in s.device_s.items() if any(n in k for n in SEGOR_KERNELS))
    if k1_s <= 0.0:
        return None
    riders: dict[tuple, list] = {}
    for r in run.answered:
        if r.engine in EDGE_ENGINES:
            riders.setdefault(r.microbatch, []).append(r)
    total = 0
    for rs in riders.values():
        r = rs[0]
        rows = len({x.text for x in rs})
        sys_ = run.systems[r.text]
        edges = [run.label_edges[a] for a in sys_.operators() if a in run.label_edges]
        total += k1_microbatch_bytes(r.sweeps, rows * sys_.n_vars, run.n_nodes, edges)
    return 100.0 * total / HBM_BYTES_PER_S / k1_s
