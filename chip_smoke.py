#!/usr/bin/env python3
"""Drive and check the torch port's query and serving paths on one card.

    python3 chip_smoke.py [--universities 8000] [--seed 0]

Run from the repository root (the script puts ``src/`` on the path
itself).  It needs one CUDA card and ``nvcc``; without a card it exits
non-zero and prints no result.  Phases, in the order they run, any
failure fatal:

1. print the card (``nvidia-smi``), build every CUDA kernel from the
   sources in the checkout, in parallel;
2. hold the segmented-OR kernel against its plain PyTorch version on the
   card, on random edge cases, for exact equality of the words;
2b. the segment-sum op ``ops.segsum`` on the card against its plain
   version (``index_add_``) on the random cases of the JAX package's
   kernel tests, f32 and f64; then, once the corpus of phase 3 is loaded,
   messages of width 70 along its ~3.0M edges summed into its ~1.32M
   nodes, driven through the op with the launch counts zeroed just before
   and read just after; two launches must give the same bits; the
   kernel's time beside its bound, its plain version and ``index_add_``;
3. the main path at real scale: stream an LUBM-shaped corpus
   (``synth.lubm_stream``; ~3.0M triples and ~1.32M nodes at 8000
   universities) through ``rdf.dump_stream`` / ``rdf.load_stream``, serve
   it through ``GraphDB`` on the card — a 16-request microbatch of the
   serving template, the L0 and L1 queries, an OPTIONAL query and a UNION
   query — then delete and re-insert one triple and query again.  The
   kernels' launch counts are zeroed just before and read just after.  The
   same queries then run through a ``device="cpu"`` ``GraphDB`` (plain
   versions) and through ``engine="jacobi_packed"`` on the card, and must
   agree;
5. serving on the card: ``AsyncServer`` with two replicas over phase 3's
   corpus takes 64 requests of the serving template from two tenants, a
   delete/re-insert churn, a dictionary-growing insert and a fence, with
   every outcome ``ok`` and equal to a direct query at the same version,
   and a warm wave under the profiler; then a poisoned request fails
   alone, and a crashed replica is quarantined, rebuilt and answers
   bit-identically to the healthy one.  The launch counts are zeroed just
   before and read just after;
3b. the dense-adjacency tier: the packed products against their plain
   versions on random cases; the same workload, mutation included, on the
   largest LUBM corpus inside the dense tier (280 universities, 46,200
   nodes) through ``engine="packed_fused"`` and ``engine="packed"``, each
   with the launch counts zeroed just before and read just after, held
   against ``engine="sparse"`` on the card and, for sweeps, against the
   same engines on the CPU at ``CPU_UNIVERSITIES``; every operator of
   the main path's plans against the plain versions, at each plan's
   initial chi and at its chi after one sweep; auto-selection of
   ``packed_fused`` on a 16,384-node, 8M-edge random graph, checked
   against ``dense``, ``packed`` and ``sparse``; and the two kernels'
   times beside their bound, their plain versions and the dense engine's
   unpacked matrix product;
4. the segmented-OR kernel against its plain version at the main path's
   own shapes, and its time (CUDA events, median of 25 launches) beside
   its bound.

The last three lines are the card's name and power limit, a JSON line of
kernel records, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
SERVE_TEMPLATE = "{{ ?d subOrganizationOf {uni} . ?s memberOf ?d }}"
UNION_QUERY = (
    "{ { ?s memberOf ?d } UNION { ?s worksFor ?d } } AND "
    "{ ?d subOrganizationOf Univ1 }"
)
# the largest LUBM corpus inside the dense tier: 165 nodes per university,
# 280 * 165 = 46,200 <= 46,340 (engine.cost.dense_tier_feasible)
DENSE_UNIVERSITIES = 280
# the corpus (9,900 nodes) of the dense tier's sweep check against the CPU
# port, whose plain products would take minutes at DENSE_UNIVERSITIES
CPU_UNIVERSITIES = 60
# the block_dense cell of src/repro/configs/dualsim_base.py: a 16k-node block
BLOCK_DENSE = dict(n_nodes=16_384, n_labels=2, n_edges=8_000_000)
AUTO_QUERY = "{ ?a p0 ?b . ?b p1 ?c }"
INT32_LANES_PER_SM, SMS = 64, 132  # H100 SXM, NVIDIA's data sheet
CARD = "cuda"  # the device of phases 2b, 3b and 5's own tensors and databases
# phase 2b's full-size case: the message width of src/repro/configs/gatedgcn.py
SEGSUM_D = 70
# phase 5: requests, batch cap, and the deadline every request is given
SERVE_REQUESTS, SERVE_BATCH, SERVE_DEADLINE_MS = 64, 16, 120_000.0
KERNELS = {
    "segsum": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/segsum/csrc/segsum.cu",
        "replaces": "src/repro/kernels/segsum/kernel.py:89",
    },
    "segor_blocks": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/segsum/csrc/segor.cu",
        "replaces": "src/repro/kernels/segsum/kernel.py:222",
    },
    "bitmm_apply_packed": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/bitmm/csrc/bitmm.cu",
        "replaces": "src/repro/kernels/bitmm/kernel.py:102",
    },
    "bitmm_packed": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/bitmm/csrc/bitmm.cu",
        "replaces": "src/repro/kernels/bitmm/kernel.py:166",
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0].split()[0]) * 1e6


def median_ms(fn, reps: int = 25, warmup: int = 3, flush=None) -> float:
    """Median time of one call of ``fn`` on the card, by CUDA events;
    ``flush`` (a tensor) is overwritten before each call, outside the
    timing, to evict the L2 cache."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions on random cases
# --------------------------------------------------------------------- #
def segor_case(rng, v, e, n, *, block_e=256, block_n=256, dst=None):
    """Operands of one segor case on the card: a random packed frontier and
    the blocked layout of ``e`` random (or given) destinations."""
    import numpy as np
    import torch

    from repro_torch.core import bitops
    from repro_torch.kernels.segsum import kernel

    frontier = rng.random((v, n)) < 0.4
    src = rng.integers(0, n, e).astype(np.int32)
    if dst is None:
        dst = rng.integers(0, n, e).astype(np.int32)
    idx_b, seg_b, win, _ = kernel.prepare_segor(
        dst, n, block_e=block_e, block_n=block_n
    )
    src_b = src[idx_b] if e else np.zeros(idx_b.shape, np.int32)
    dev = torch.device("cuda")
    return (bitops.to_words(bitops.pack_np(frontier), dev),
            torch.as_tensor(src_b, device=dev),
            torch.as_tensor(seg_b, device=dev),
            torch.as_tensor(win, device=dev))


def check_segor(args, n, block_n=256) -> int:
    """Kernel vs plain version on the card; returns the max abs difference
    of the words read as uint32 (0 when they agree)."""
    import torch

    from repro_torch.kernels.segsum import kernel, ref

    got = kernel.segor_blocks(*args, num_segments=n, block_n=block_n)
    want = ref.segor_blocks_ref(*args, num_segments=n, block_n=block_n)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) & 0xFFFFFFFF).sub(
        want.to(torch.int64) & 0xFFFFFFFF).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"segor kernel != plain version (n={n}, "
                             f"V={args[0].shape[0]}, max err {err})")
    return err


def phase_kernel_cases(seed: int) -> int:
    import numpy as np

    rng = np.random.default_rng(seed)
    cases = 0
    for v in (1, 5, 32, 48, 128):
        for n in (33, 77, 1000, 4099):
            check_segor(segor_case(rng, v, 4 * n, n), n)
            cases += 1
    check_segor(segor_case(rng, 8, 0, 70), 70)  # no edges at all
    check_segor(segor_case(rng, 8, 2000, 40, dst=np.full(2000, 7, np.int32)), 40)
    bounds = np.asarray([0, 255, 256, 257, 511, 512, 599] * 40, np.int32)
    check_segor(segor_case(rng, 16, len(bounds), 600, dst=bounds), 600)
    # one window revisited by many blocks, default and small blocks
    check_segor(segor_case(rng, 48, 20_000, 300,
                           dst=rng.integers(0, 200, 20_000).astype(np.int32)), 300)
    check_segor(segor_case(rng, 9, 900, 50, block_e=64, block_n=32), 50,
                block_n=32)
    cases += 5
    try:
        check_segor(segor_case(rng, 8000, 10, 64), 64)
    except ValueError:
        pass  # V past the shared-memory limit is refused, never launched
    else:
        raise AssertionError("segor accepted V past the shared-memory limit")
    return cases


# --------------------------------------------------------------------- #
# phase 2b: the segment-sum op against its plain version
# --------------------------------------------------------------------- #
def segsum_tol(dtype) -> float:
    """rtol = atol of a segment sum against its plain version."""
    import numpy as np

    return 1e-12 if dtype == np.float64 else 1e-5


def check_segsum(vals, ids, n, **kw) -> float:
    """``ops.segsum`` on the card against the plain version (``index_add_``
    on the same values and ids); two launches must give the same bits.
    Returns the max abs difference."""
    import torch

    from repro_torch.kernels.segsum import kernel, ops, ref

    got = ops.segsum(vals, ids, n, device=CARD, **kw)
    dev = got.device
    keep = (ids >= 0) & (ids < n)
    want = ref.segsum_ref(torch.as_tensor(vals[keep], device=dev),
                          torch.as_tensor(ids[keep], device=dev), n)
    order, row_ptr = kernel.prepare_csr(ids, n)
    vals_s = torch.as_tensor(vals[order], device=dev)
    row_ptr = torch.as_tensor(row_ptr, device=dev)
    again = kernel.segsum_csr(vals_s, row_ptr)
    again2 = kernel.segsum_csr(vals_s, row_ptr)
    if CARD == "cuda":
        torch.cuda.synchronize()
    shape = f"E={len(ids)}, N={n}, D={vals.shape[1]}, {vals.dtype}"
    if got.shape != (n, vals.shape[1]) or got.dtype != want.dtype:
        raise AssertionError(f"segsum shape/dtype {tuple(got.shape)} {got.dtype} ({shape})")
    if not (torch.equal(got, again) and torch.equal(again, again2)):
        raise AssertionError(f"segsum launches differ in their bits ({shape})")
    tol = segsum_tol(vals.dtype)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"segsum kernel != plain version ({shape}, max err {err})")
    return err


def phase_segsum_cases(seed: int) -> tuple[int, float]:
    """The random cases of the JAX package's segment-sum tests, and edge
    cases of the sorted layout; returns (cases, max abs difference)."""
    import numpy as np
    import torch

    from repro_torch.kernels.segsum import ops

    rng = np.random.default_rng(seed + 2)
    err, cases = 0.0, 0
    for e, n, d in ((100, 64, 8), (1000, 300, 16), (37, 513, 3),
                    (5000, 100, 70), (4000, 700, 128), (3000, 50, 200)):
        for dtype in (np.float32, np.float64):
            vals = rng.normal(size=(e, d)).astype(dtype)
            err = max(err, check_segsum(vals, rng.integers(0, n, e).astype(np.int32), n))
            cases += 1
    for dtype in (np.float32, np.float64):
        vals = rng.normal(size=(200, 5)).astype(dtype)
        err = max(err, check_segsum(vals, rng.integers(0, 40, 200).astype(np.int32), 40))
        cases += 1
    out = ops.segsum(np.zeros((0, 4), np.float32), np.zeros(0, np.int32), 8, device=CARD)
    if out.shape != (8, 4) or bool(out.any()):
        raise AssertionError("segsum of no rows is not zero")
    out = ops.segsum(np.ones((5, 3), np.float32), np.zeros(5, np.int32), 0, device=CARD)
    if out.shape != (0, 3):
        raise AssertionError("segsum with no segments is not empty")
    out = ops.segsum(np.ones((16, 4), np.float32), np.zeros(16, np.int32), 1, device=CARD)
    if not torch.equal(out.cpu(), torch.full((1, 4), 16.0)):
        raise AssertionError("segsum of one segment != 16")
    bounds = np.asarray([0, 255, 256, 257, 511, 512, 599] * 10, np.int32)
    err = max(err, check_segsum(np.ones((len(bounds), 2), np.float32), bounds, 600,
                                block_n=256))
    ids = rng.integers(-5, 105, 500).astype(np.int32)  # ids outside: no segment
    err = max(err, check_segsum(rng.normal(size=(500, 3)).astype(np.float32), ids, 100))
    cases += 5
    for bad in (np.float16, np.int32):
        try:
            ops.segsum(np.ones((4, 2), bad), np.zeros(4, np.int32), 2, device=CARD)
        except TypeError:
            pass
        else:
            raise AssertionError(f"segsum accepted {bad.__name__} values")
    return cases, err


def phase_segsum_full(graph, seed: int) -> dict:
    """Phase 2b at full size: width-70 messages along every edge of the
    corpus, summed into their objects, through ``ops.segsum`` with the
    launch counts zeroed just before and read just after; then the kernel
    against its plain version, and its time."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.segsum import kernel, ops, ref

    rng = np.random.default_rng(seed + 3)
    ids = np.ascontiguousarray(graph.triples[:, 2], dtype=np.int32)
    n, e, d = graph.n_nodes, len(ids), SEGSUM_D
    vals = rng.standard_normal((e, d), dtype=np.float32)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = ops.segsum(vals, ids, n, device=CARD)
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t0
    launches = kernels.launch_counts().get("segsum", 0)
    if not launches:
        raise AssertionError("ops.segsum never launched the segsum kernel")
    err = check_segsum(vals, ids, n)
    dev = out.device
    order, row_ptr = kernel.prepare_csr(ids, n)
    vals_s = torch.as_tensor(vals[order], device=dev)
    row_ptr = torch.as_tensor(row_ptr, device=dev)
    vals_d = torch.as_tensor(vals, device=dev)
    ids_d = torch.as_tensor(ids, device=dev).long()
    if not torch.equal(kernel.segsum_csr(vals_s, row_ptr), out):
        raise AssertionError("segsum: the op and the kernel on its layout differ")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2
    ms = median_ms(lambda: kernel.segsum_csr(vals_s, row_ptr), flush=flush)
    plain_ms = median_ms(lambda: ref.segsum_csr_ref(vals_s, row_ptr), flush=flush)
    lib_ms = median_ms(
        lambda: torch.zeros((n, d), device=dev).index_add_(0, ids_d, vals_d),
        flush=flush)
    ms_again = median_ms(lambda: kernel.segsum_csr(vals_s, row_ptr), flush=flush)
    bytes_moved = e * d * 4 + e * 4 + n * d * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops = e * d  # one add per value
    by_ops = flops / 67e12 * 1e3  # f32 non-tensor peak, NVIDIA's data sheet
    deg = np.bincount(ids, minlength=n)
    log(f"segsum at E={e}, N={n}, D={d}, f32 (messages along the corpus's "
        f"edges into their objects; in-degree max {int(deg.max())}, mean "
        f"{e / n:.3f}, {int((deg == 0).sum())} empty segments): max err "
        f"{err:.3g} (rtol = atol = {segsum_tol(np.float32)}), launches {launches}; "
        f"op (host sort, upload, kernel) {op_s:.3f}s; kernel {ms:.4f} ms "
        f"(again {ms_again:.4f} ms, L2 flushed), plain {plain_ms:.4f} ms, "
        f"library index_add_ {lib_ms:.4f} ms; bound {bound_ms:.4f} ms for "
        f"{bytes_moved} bytes (vals + ids + out) at 3.35 TB/s, "
        f"{by_ops:.4f} ms for {flops} adds at 67 TFLOP/s")
    del flush, vals_s, vals_d, ids_d, out
    free_card()
    return {"name": "segsum", **KERNELS["segsum"], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_ms, by_ops),
            "bound_by": "bytes" if bound_ms >= by_ops else "operations",
            "library_ms": lib_ms}


# --------------------------------------------------------------------- #
# phase 3: the main path
# --------------------------------------------------------------------- #
def load_corpus(n_universities: int, seed: int):
    from repro_torch.data import rdf, synth

    path = ROOT / "build" / "smoke" / f"lubm_{n_universities}_{seed}.nt"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    n = rdf.dump_stream(synth.lubm_stream(n_universities, seed=seed), str(path))
    t1 = time.perf_counter()
    graph = rdf.load_stream(str(path))
    t2 = time.perf_counter()
    path.unlink()
    log(f"corpus: {n} triples, {graph.n_nodes} nodes, {graph.n_labels} labels;"
        f" dump {t1 - t0:.1f}s, load {t2 - t1:.1f}s")
    return graph


def workload():
    """(name, list of query texts) in the order the main path runs them."""
    from repro_torch.core import sparql
    from repro_torch.data import synth

    return [
        ("serve_template_x16",
         [SERVE_TEMPLATE.format(uni=f"Univ{u}") for u in range(16)]),
        ("lubm_l0", [sparql.format_query(synth.lubm_l0_like())]),
        ("lubm_l1", [sparql.format_query(synth.lubm_l1_like())]),
        ("optional", [sparql.format_query(synth.optional_query())]),
        ("union", [UNION_QUERY]),
    ]


def sync(db) -> None:
    """Wait for the card when ``db`` runs on one."""
    import torch

    if db._engine.device.type == "cuda":
        torch.cuda.synchronize()


def serve(db, *, warm: bool = True, kernel: str = "segor_blocks"):
    """Run the workload through ``db`` cold, then (``warm``) once more from
    the plan cache; returns {name: (results, cold_s, warm_s, launches,
    stages)}: ``launches`` counts the launches of ``kernel`` in the cold
    run, ``stages`` the engine's per-stage seconds of the warm run."""
    from repro_torch import kernels

    out = {}
    for name, texts in workload():
        before = kernels.LAUNCHES.get(kernel, 0)
        t0 = time.perf_counter()
        res = db.execute_many(texts)
        sync(db)
        cold = time.perf_counter() - t0
        launches = kernels.LAUNCHES.get(kernel, 0) - before
        warm_s, stages = None, {}
        if warm:
            before = db.metrics().stage_seconds
            t0 = time.perf_counter()
            again = db.execute_many(texts)
            warm_s = time.perf_counter() - t0
            after = db.metrics().stage_seconds
            stages = {k: after[k] - before.get(k, 0.0) for k in after}
            for a, b in zip(res, again):
                if not b.cache_hit or a.sweeps != b.sweeps:
                    raise AssertionError(f"{name}: warm run missed the plan cache")
        out[name] = (res, cold, warm_s, launches, stages)
    return out


def same_results(name, got, want, *, sweeps=True):
    import numpy as np

    for a, b in zip(got, want):
        if not np.array_equal(a.survivor_mask, b.survivor_mask):
            raise AssertionError(f"{name}: survivor masks differ")
        if a.variables != b.variables or any(
            not np.array_equal(a.binding_mask(v), b.binding_mask(v))
            for v in a.variables
        ):
            raise AssertionError(f"{name}: bindings differ")
        if sweeps and a.sweeps != b.sweeps:
            raise AssertionError(f"{name}: sweeps {a.sweeps} != {b.sweeps}")


def phase_main_path(graph):
    from repro_torch import kernels
    from repro_torch.db import GraphDB
    from repro_torch.engine import cost

    if cost.dense_tier_feasible(graph.n_nodes):
        raise AssertionError("corpus is within the dense tier; use more universities")
    db = GraphDB(graph)  # the default device: the card
    kernels.reset_launches()
    runs = serve(db)
    resume_delete, resume_insert = churn(db, graph, runs)
    launches = dict(kernels.LAUNCHES)
    m = db.metrics()
    if not launches.get("segor_blocks"):
        raise AssertionError("the main path never launched segor_blocks")
    for name, (res, *_rest) in runs.items():
        engines = {e for r in res for e in r.engine.split(",")}
        if engines != {"sparse"}:
            raise AssertionError(f"{name}: cost model chose {engines}")
    log(f"main path: engine=sparse, segor launches {launches}, "
        f"plans_resumed {m.plans_resumed}, warm_resume_solves "
        f"{m.warm_resume_solves}; resume after delete {resume_delete:.4f}s, "
        f"after insert {resume_insert:.4f}s")
    return db, runs, launches


def churn(db, graph, runs) -> tuple[float, float]:
    """Shape-stable delete + re-insert of one ``memberOf`` triple, each
    followed by the serving template's requests; checks that a plan
    resumed and that the answers came back.  Returns the two requery
    latencies (seconds)."""
    import numpy as np

    row = graph.triples[int(np.flatnonzero(
        graph.triples[:, 1] == graph.label_id("memberOf"))[0])]
    t = tuple(n[i] for n, i in zip(
        (graph.node_names, graph.label_names, graph.node_names), row))
    texts = workload()[0][1]
    if db.delete([t]) != 1:
        raise AssertionError("delete of an existing triple removed nothing")
    t0 = time.perf_counter()
    after_delete = db.execute_many(texts)
    sync(db)
    resume_delete = time.perf_counter() - t0
    if db.insert([t]) != 1:
        raise AssertionError("re-insert added nothing")
    t0 = time.perf_counter()
    after_insert = db.execute_many(texts)
    sync(db)
    resume_insert = time.perf_counter() - t0
    m = db.metrics()
    if m.plans_resumed < 1:
        raise AssertionError(f"no plan resumed after the mutation: {m}")
    # the re-inserted graph equals the original up to triple order
    same_bindings = all(
        np.array_equal(a.binding_mask(v), b.binding_mask(v))
        for a, b in zip(after_insert, runs["serve_template_x16"][0])
        for v in a.variables
    )
    if not same_bindings or len(after_delete) != len(texts):
        raise AssertionError("answers after delete + re-insert changed")
    return resume_delete, resume_insert


def phase_cross_checks(graph, runs):
    from repro_torch.db import GraphDB

    t0 = time.perf_counter()
    cpu = serve(GraphDB(graph, device="cpu"), warm=False)
    for name, (res, *_rest) in runs.items():
        same_results(name, res, cpu[name][0])
    log(f"cpu GraphDB (plain versions): survivors, bindings and sweeps equal "
        f"on every query ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    jac = serve(GraphDB(graph, engine="jacobi_packed"), warm=False)
    for name, (res, *_rest) in runs.items():
        same_results(name, res, jac[name][0], sweeps=False)
    log(f"jacobi_packed on the card: survivors and bindings equal "
        f"({time.perf_counter() - t0:.1f}s)")


# --------------------------------------------------------------------- #
# phase 3b: the dense-adjacency tier
# --------------------------------------------------------------------- #
def bitmm_case(rng, v, n, *, density=0.1, chi_density=0.6, flags=0.5):
    """A random packed chi, packed adjacency and 0/1 flags on the card."""
    import numpy as np
    import torch

    from repro_torch.core import bitops

    dev = torch.device(CARD)
    a = rng.random((n, n)) < density
    chi = rng.random((v, n)) < chi_density
    f = (rng.random((v, v)) < flags).astype(np.int32)
    return (bitops.to_words(bitops.pack_np(chi), dev),
            bitops.to_words(bitops.pack_np(a), dev),
            torch.as_tensor(f, device=dev))


def u32_err(got, want) -> int:
    """Max abs difference of two int32 word tensors read as uint32."""
    import torch

    if not got.numel():
        return 0
    return int((got.to(torch.int64) & 0xFFFFFFFF).sub(
        want.to(torch.int64) & 0xFFFFFFFF).abs().max())


def check_bitmm(chi_p, a_p, flags) -> tuple[int, int]:
    """Both packed products against their plain versions on the card, for
    exact equality of the words and of the changed word; returns each
    kernel's max abs difference of the words read as uint32 (0 when they
    agree)."""
    import torch

    from repro_torch.core import bitops
    from repro_torch.kernels.bitmm import kernel, ref

    new, ch = kernel.bitmm_apply(chi_p, a_p, flags)
    want, want_ch = ref.bitmm_apply_ref(chi_p, a_p, flags)
    x = bitops.unpack(chi_p, a_p.shape[0])
    out = kernel.bitmm_packed(x, a_p)
    want_out = ref.bitmm_packed_ref(x, a_p)
    torch.cuda.synchronize()
    errs = (u32_err(new, want), u32_err(out, want_out))
    shape = f"V={chi_p.shape[0]}, n={a_p.shape[0]}"
    if not torch.equal(new, want) or int(ch) != int(want_ch):
        raise AssertionError(f"bitmm_apply_packed != plain ({shape}, "
                             f"err {errs[0]}, changed {int(ch)} vs "
                             f"{int(want_ch)})")
    if not torch.equal(out, want_out):
        raise AssertionError(f"bitmm_packed != plain ({shape}, err {errs[1]})")
    return errs


def bitmm_random_cases(seed: int) -> int:
    import numpy as np
    import torch

    from repro_torch.kernels.bitmm import kernel

    rng = np.random.default_rng(seed + 1)
    cases = 0
    for v in (1, 2, 5, 16, 33, 48, 64):
        for n in (1, 7, 31, 32, 33, 100, 1000, 4099):
            check_bitmm(*bitmm_case(rng, v, n))
            cases += 1
    for density in (0.0, 0.01, 0.5, 1.0):
        check_bitmm(*bitmm_case(rng, 9, 777, density=density))
        cases += 1
    chi_p, a_p, f = bitmm_case(rng, 12, 500, chi_density=0.0)  # empty frontier
    check_bitmm(chi_p, a_p, f)
    chi_p, a_p, f = bitmm_case(rng, 12, 500)
    new, ch = kernel.bitmm_apply(chi_p, a_p, torch.zeros_like(f))
    if not torch.equal(new, chi_p) or int(ch) != 0:
        raise AssertionError("all-zero flags moved chi")
    for _ in range(100):  # iterate to the fixpoint: changed must go quiet
        check_bitmm(chi_p, a_p, f)
        new, ch = kernel.bitmm_apply(chi_p, a_p, f)
        if int(ch) == 0:
            if not torch.equal(new, chi_p):
                raise AssertionError("changed == 0 but chi moved")
            break
        chi_p = new
    else:
        raise AssertionError("the fused step never converged")
    cases += 4
    chi_p, a_p, _ = bitmm_case(rng, 1761, 64)
    try:
        kernel.bitmm_apply(chi_p, a_p, torch.zeros((1761, 1761),
                                                   dtype=torch.int32,
                                                   device=CARD))
    except ValueError:
        pass  # V past the shared-memory limit is refused, never launched
    else:
        raise AssertionError("bitmm accepted V past the shared-memory limit")
    return cases


def stages(rs) -> str:
    """A result's plan / solve / prune seconds."""
    return ", ".join(f"{k} {rs.timings[k]:.3f}s"
                     for k in ("plan", "solve", "prune"))


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def dense_tier_path(graph, engine: str, kernel: str):
    """Drive the workload (and the mutation) through ``engine`` on the card
    with the launch counts zeroed just before and read just after."""
    from repro_torch import kernels
    from repro_torch.db import GraphDB

    db = GraphDB(graph, engine=engine)
    kernels.reset_launches()
    t0 = time.perf_counter()
    runs = serve(db, kernel=kernel)
    resume_delete, resume_insert = churn(db, graph, runs)
    launches = dict(kernels.LAUNCHES)
    seconds = time.perf_counter() - t0
    if not launches.get(kernel):
        raise AssertionError(f"the {engine} path never launched {kernel}")
    m = db.metrics()
    adj = db._engine._adj_cache.values()
    adj_bytes = sum(a.numel() * a.element_size() for _, a in adj)
    log(f"dense tier, engine={engine}: launches {launches}, plans_resumed "
        f"{m.plans_resumed}, resume after delete {resume_delete:.4f}s, after "
        f"insert {resume_insert:.4f}s; {seconds:.1f}s; cached packed "
        f"adjacency {adj_bytes} bytes on the card "
        f"(peak allocated {max_allocated()} bytes)")
    return db, runs, launches


def max_allocated() -> int:
    import torch

    return torch.cuda.max_memory_allocated()


def reset_peak() -> None:
    import torch

    torch.cuda.reset_peak_memory_stats()


def plans_of(db):
    """The plans of the workload in ``db`` (name, plan), union parts apart:
    cached, or resumed onto the current snapshot."""
    from repro_torch.core import sparql
    from repro_torch.engine import canonicalize

    out = []
    for name, texts in workload():
        for part in sparql.union_split(sparql.parse(texts[0])):
            plan, _ = db._engine.plan_for(canonicalize(part),
                                          bucket=len(texts))
            out.append((name, plan))
    return out


def time_bitmm(plan, clock_hz: float) -> tuple[dict, dict]:
    """Both kernels at the largest main-path shape, on the plan's first
    operator and its init chi (the work depends on the rows and bits the
    frontier selects, the same for every operator), their plain versions,
    the dense engine's unpacked f32 product on the same inputs, and their
    bound; returns the two records' numbers."""
    import torch

    from repro_torch.core import bitops
    from repro_torch.kernels.bitmm import kernel, ref

    ops, n = plan.operands, plan.n_nodes
    chi_p = ops.init_packed
    v, nw = chi_p.shape
    x = bitops.unpack(chi_p, n)
    rows = x.any(0)  # contraction rows some variable selects
    set_bits = int(x.sum())
    live = int(rows.sum())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=CARD)  # > L2
    m = 0
    a = ops.adj_packed[m]
    flags = ops.mat_lhs_flags[m]
    rate_ops = SMS * INT32_LANES_PER_SM * clock_hz
    out = {}
    for name, fn, plain, extra in (
        ("bitmm_apply_packed", lambda: kernel.bitmm_apply(chi_p, a, flags),
         lambda: ref.bitmm_apply_ref(chi_p, a, flags), 2 * v * nw * 4 + v * v * 4),
        ("bitmm_packed", lambda: kernel.bitmm_packed(x, a),
         lambda: ref.bitmm_packed_ref(x, a), v * n + v * nw * 4),
    ):
        ms = median_ms(fn, flush=flush)
        plain_ms = median_ms(plain, flush=flush)
        ms_again = median_ms(fn, flush=flush)
        bytes_moved = live * nw * 4 + extra
        word_ops = set_bits * nw
        by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        by_ops = word_ops / rate_ops * 1e3
        full_bytes = n * nw * 4 + extra
        full_ops = v * n * nw
        log(f"{name} at V={v}, n={n}, nw={nw} (operator {m} of the 16-request "
            f"microbatch plan; A {n * nw * 4} bytes, L2 50 MB, flushed before "
            f"each launch): kernel {ms:.4f} ms (again "
            f"{ms_again:.4f} ms), plain {plain_ms:.4f} ms; this input selects "
            f"{live} of {n} rows and holds {set_bits} set bits: bound "
            f"max({by_bytes:.4f} ms for {bytes_moved} bytes at 3.35 TB/s, "
            f"{by_ops:.4f} ms for {word_ops} word ops at {SMS} SMs x "
            f"{INT32_LANES_PER_SM} int32 lanes x {clock_hz / 1e6:.0f} MHz); "
            f"every row and bit: {full_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
            f"bytes, {full_ops / rate_ops * 1e3:.4f} ms for {full_ops} ops")
        out[name] = dict(ms=ms, plain_ms=plain_ms,
                         bound_ms=max(by_bytes, by_ops),
                         bound_by="bytes" if by_bytes >= by_ops else "operations")
    del flush
    # the dense engine's own product on unpacked 0/1 f32 at the same V, n
    dense = bitops.unpack(a, n).to(torch.float32)
    xf = x.to(torch.float32)
    lib_ms = median_ms(lambda: torch.matmul(xf, dense))
    log(f"library_ms (unpacked product): torch.matmul of f32 [{v}, {n}] @ "
        f"[{n}, {n}] {lib_ms:.4f} ms")
    del dense, xf
    free_card()
    for rec in out.values():
        rec["library_ms"] = lib_ms
    return out["bitmm_apply_packed"], out["bitmm_packed"]


def phase_dense_tier(seed: int):
    """Phase 3b; returns the two kernels' records."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import bitops, dualsim, sparql
    from repro_torch.data import synth
    from repro_torch.db import GraphDB
    from repro_torch.engine import canonicalize, cost

    t_phase = time.perf_counter()
    log(f"phase 3b: bitmm kernels == plain versions on "
        f"{bitmm_random_cases(seed)} random cases")
    graph = load_corpus(DENSE_UNIVERSITIES, seed)
    n = graph.n_nodes
    if not cost.dense_tier_feasible(n):
        raise AssertionError(f"n={n} is past the dense tier")
    nw = (n + 31) // 32
    log(f"dense tier corpus: n={n}, nw={nw}; one operator's packed adjacency "
        f"is {n} x {nw} x 4 = {n * nw * 4} bytes")

    fused_db, fused, fused_launches = dense_tier_path(
        graph, "packed_fused", "bitmm_apply_packed")
    errs = [0, 0]
    n_ops = 0
    for _, plan in plans_of(fused_db):  # every operator of every plan
        ops = plan.operands
        # the plan's initial chi, and its chi in mid-fixpoint
        swept, _ = dualsim.solve_packed_fused(ops, max_sweeps=1)
        for chi_p in (ops.init_packed, bitops.pack(swept)):
            for m in range(ops.adj_packed.shape[0]):
                errs = [max(a, b) for a, b in zip(errs, check_bitmm(
                    chi_p, ops.adj_packed[m], ops.mat_lhs_flags[m]))]
                n_ops += 1
    log(f"bitmm kernels == plain versions on every main-path operator, at "
        f"the initial chi and after one sweep ({n_ops} checks)")
    fused_rec, packed_rec = time_bitmm(plans_of(fused_db)[0][1], sm_clock_hz())
    del fused_db
    free_card()
    packed_db, packed, packed_launches = dense_tier_path(
        graph, "packed", "bitmm_packed")
    del packed_db
    free_card()
    t0 = time.perf_counter()
    sparse = serve(GraphDB(graph, engine="sparse"), warm=False)
    free_card()
    for name, (res, *_rest) in fused.items():
        same_results(name, res, sparse[name][0], sweeps=False)
        same_results(name, res, packed[name][0], sweeps=False)
    log(f"packed_fused and packed == sparse on the card: survivors and "
        f"bindings ({time.perf_counter() - t0:.1f}s)")
    for name in fused:
        for engine, runs, kernel in (
            ("packed_fused", fused, "bitmm_apply_packed"),
            ("packed", packed, "bitmm_packed"),
        ):
            res, cold, warm, n_launch, _ = runs[name]
            log(f"dense tier query {name} ({engine}): requests {len(res)}, "
                f"batch {res[0].batch}, sweeps {res[0].sweeps}, cold "
                f"{cold:.4f}s, warm {warm:.4f}s, {kernel} launches per query "
                f"(cold run) {n_launch / len(res):.2f}")

    # sweeps against the CPU port, on a smaller corpus
    t0 = time.perf_counter()
    small = load_corpus(CPU_UNIVERSITIES, seed)
    for engine in ("packed_fused", "packed"):
        card = serve(GraphDB(small, engine=engine), warm=False)
        cpu = serve(GraphDB(small, engine=engine, device="cpu"), warm=False)
        for name, (res, *_rest) in card.items():
            same_results(name, res, cpu[name][0])
    free_card()
    log(f"packed_fused and packed on the card == the CPU port at "
        f"{CPU_UNIVERSITIES} universities ({small.n_nodes} nodes): survivors, "
        f"bindings and sweeps ({time.perf_counter() - t0:.1f}s)")

    # auto selection on the block_dense graph
    t0 = time.perf_counter()
    block = synth.random_graph(**BLOCK_DENSE, seed=seed)
    auto_db = GraphDB(block)
    kernels.reset_launches()
    t1 = time.perf_counter()
    auto = auto_db.query(AUTO_QUERY)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t1
    auto_launches = dict(kernels.LAUNCHES)
    plan, _ = auto_db._engine.plan_for(canonicalize(sparql.parse(AUTO_QUERY)))
    if auto.engine != "packed_fused" or not auto_launches.get(
            "bitmm_apply_packed"):
        raise AssertionError(f"auto chose {auto.engine} ({plan.cost.reason}), "
                             f"launches {auto_launches}")
    log(f"auto on the {BLOCK_DENSE} random graph: {plan.cost.reason}; "
        f"{auto_s:.3f}s cold ({stages(auto)}), sweeps {auto.sweeps}, "
        f"launches {auto_launches}")
    del auto_db, plan
    free_card()
    for engine in ("dense", "packed", "sparse"):
        other_db = GraphDB(block, engine=engine)
        t1 = time.perf_counter()
        other = other_db.query(AUTO_QUERY)
        torch.cuda.synchronize()
        other_s = time.perf_counter() - t1
        del other_db
        free_card()
        if not np.array_equal(auto.survivor_mask, other.survivor_mask) or any(
                not np.array_equal(auto.binding_mask(v), other.binding_mask(v))
                for v in auto.variables):
            raise AssertionError(f"block_dense: {engine} != packed_fused")
        log(f"block_dense: {engine} == packed_fused (sweeps {other.sweeps}, "
            f"{other_s:.3f}s cold: {stages(other)})")
    t1 = time.perf_counter()
    block.packed_adjacency(0)
    t2 = time.perf_counter()
    block.dense_adjacency(0)
    log(f"block_dense host build of one operator: packed "
        f"{t2 - t1:.3f}s, dense {time.perf_counter() - t2:.3f}s")
    log(f"block_dense checks {time.perf_counter() - t0:.1f}s")
    log(f"phase 3b seconds: {time.perf_counter() - t_phase:.1f}")
    fused_rec.update(launches=fused_launches.get("bitmm_apply_packed", 0),
                     max_abs_err=errs[0])
    packed_rec.update(launches=packed_launches.get("bitmm_packed", 0),
                      max_abs_err=errs[1])
    return [
        {"name": "bitmm_apply_packed", **KERNELS["bitmm_apply_packed"],
         **fused_rec},
        {"name": "bitmm_packed", **KERNELS["bitmm_packed"], **packed_rec},
    ]


# --------------------------------------------------------------------- #
# phase 5: serving on the card
# --------------------------------------------------------------------- #
def serve_texts(n_universities: int, seed: int) -> list[str]:
    """The serving template over random universities of the corpus."""
    import numpy as np

    rng = np.random.default_rng(seed + 5)
    return [SERVE_TEMPLATE.format(uni=f"Univ{u}")
            for u in rng.integers(0, n_universities, SERVE_REQUESTS)]


def truths(db, texts) -> dict:
    """``{text: ResultSet}`` of a direct ``db.query`` of each text."""
    return {t: db.query(t) for t in dict.fromkeys(texts)}


def check_served(stage, results, texts, want) -> None:
    """Every outcome ``ok``, on the snapshot ``want`` was taken on, with
    survivors and bindings equal to it."""
    import numpy as np

    for r, t in zip(results, texts):
        if not r.ok:
            raise AssertionError(f"{stage}: outcome {r.outcome} ({r.detail})")
        ref = want[t]
        if r.result.snapshot is not ref.snapshot:
            raise AssertionError(f"{stage}: served on another snapshot")
        if not np.array_equal(r.result.survivor_mask, ref.survivor_mask) or any(
                not np.array_equal(r.result.binding_mask(v), ref.binding_mask(v))
                for v in ref.variables):
            raise AssertionError(f"{stage}: {t} differs from a direct query")


async def serve_stream(server, db, graph, texts):
    """The ``launch/serve.py --mutate`` sequence: the requests from two
    tenants, a delete/re-insert churn, a dictionary-growing insert and a
    fence, then one warm wave under the profiler; each wave held against
    direct queries at its version."""
    import asyncio

    import numpy as np

    def submit(batch):
        return asyncio.gather(*[server.submit(t, tenant=f"t{i % 2}")
                                for i, t in enumerate(batch)])

    want = truths(db, texts)
    t0 = time.perf_counter()
    results = await submit(texts)
    wall = time.perf_counter() - t0
    check_served("requests", results, texts, want)
    totals = [r.total_ms for r in results]
    row = graph.triples[int(np.flatnonzero(
        graph.triples[:, 1] == graph.label_id("memberOf"))[0])]
    churn = [tuple(n[i] for n, i in zip(
        (graph.node_names, graph.label_names, graph.node_names), row))]
    mid = texts[:SERVE_BATCH]
    if db.delete(churn) != 1:
        raise AssertionError("delete of an existing triple removed nothing")
    want = truths(db, mid)
    t0 = time.perf_counter()
    check_served("after delete", await submit(mid), mid, want)
    resume_s = time.perf_counter() - t0
    db.insert(churn)
    db.insert([("DeptNew", "subOrganizationOf", "Univ0"),
               ("StudentNew", "memberOf", "DeptNew")])
    fenced = await server.fence()
    if fenced != db.version:
        raise AssertionError(f"fence reached v{fenced}, not v{db.version}")
    want = truths(db, mid)
    t0 = time.perf_counter()
    check_served("after fence", await submit(mid), mid, want)
    cold_s = time.perf_counter() - t0
    # the other replica builds its plan too; then one wave, warm on either
    # replica, under the profiler: the card's share of serving
    check_served("second replica", await submit(mid), mid, want)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = await submit(mid)
        warm_s = time.perf_counter() - t0
    check_served("warm", again, mid, want)
    if not all(r.result.cache_hit for r in again):
        raise AssertionError("the profiled wave missed the plan cache")
    waves = (f"{len(mid)}-request waves: after the delete (resumed plan) "
             f"{resume_s:.3f}s, after the dictionary-growing insert and the "
             f"fence (cold plan) {cold_s:.3f}s, warm {warm_s:.3f}s; profiled "
             f"warm wave: {trace_share(prof, warm_s)}")
    return wall, totals, len(texts) + 4 * len(mid), waves


async def serve_faults(server, plan, texts):
    """A poisoned request among good ones fails alone and leaves every
    replica healthy; then replica r0 crashes, is quarantined and rebuilt,
    and answers bit-identically to r1.  Returns the health events."""
    import asyncio

    import numpy as np

    from repro_torch.faults import InjectedPoison
    from repro_torch.serve import HEALTHY

    good = texts[0]
    poison = SERVE_TEMPLATE.format(uni="PoisonX")
    plan.arm()
    got = await asyncio.gather(*[server.submit(t) for t in (good, poison, good, good)])
    if [r.outcome for r in got] != ["ok", "error", "ok", "ok"] or not isinstance(
            got[1].error, InjectedPoison):
        raise AssertionError(f"poison: {[(r.outcome, r.detail) for r in got]}")
    if any(h["state"] != HEALTHY for h in server.router.health()):
        raise AssertionError(f"poison was blamed on a replica: {server.router.health()}")
    plan.crash_replica("r0", at_batch=1).arm()
    by_replica = {}
    for _ in range(40):
        r = await server.submit(good)
        if not r.ok:
            raise AssertionError(f"crash: outcome {r.outcome} ({r.detail})")
        by_replica.setdefault(r.replica, r)
        if any(e["replica"] == "r0" and e["event"] == "quarantined"
               for e in server.router.events()):
            break
    else:
        raise AssertionError("the crashed replica was never quarantined")
    loop = asyncio.get_running_loop()
    if not await loop.run_in_executor(None, server.router.wait_rebuilt, 60.0):
        raise AssertionError(f"r0 was not rebuilt: {server.router.health()}")
    healed = None
    for _ in range(8):
        r = await server.submit(good)
        if not r.ok:
            raise AssertionError(f"rebuilt: outcome {r.outcome} ({r.detail})")
        by_replica.setdefault(r.replica, r)
        if r.replica == "r0":
            healed = r
            break
    if healed is None or "r1" not in by_replica:
        raise AssertionError(f"no answer from both replicas: {sorted(by_replica)}")
    base = by_replica["r1"].result
    if not np.array_equal(healed.result.survivor_mask, base.survivor_mask) or any(
            not np.array_equal(healed.result.binding_mask(v), base.binding_mask(v))
            for v in base.variables):
        raise AssertionError("the rebuilt replica's answer differs from r1's")
    health = {h["name"]: h for h in server.router.health()}
    if health["r0"]["epoch"] < 1 or health["r0"]["rebuilds"] < 1:
        raise AssertionError(f"r0 not rebuilt: {health['r0']}")
    return server.router.events()


def phase_serving(graph, n_universities: int, seed: int) -> None:
    """Phase 5: ``AsyncServer`` with two replicas over the corpus on the
    card, launch counts zeroed just before and read just after."""
    import asyncio

    from repro_torch import kernels
    from repro_torch.db import GraphDB
    from repro_torch.faults import FaultPlan
    from repro_torch.serve import AsyncServer

    t_phase = time.perf_counter()
    texts = serve_texts(n_universities, seed)
    db = GraphDB(graph, device=CARD)
    plan = FaultPlan(seed).poison_matching("Poison")
    reset_peak()

    async def go():
        async with AsyncServer(
            db, replicas=2, max_batch=SERVE_BATCH, fault_plan=plan,
            default_deadline_ms=SERVE_DEADLINE_MS,
        ) as server:
            stream = await serve_stream(server, db, graph, texts)
            snap = server.metrics.snapshot()
            agg = server.router.aggregate()
            events = await serve_faults(server, plan, texts)
            return (*stream, snap, agg, events, server.metrics.snapshot())

    kernels.reset_launches()
    wall, totals, n_stream, waves, snap, agg, events, final = asyncio.run(go())
    launches = kernels.launch_counts()
    if not launches.get("segor_blocks"):
        raise AssertionError(f"serving never launched segor_blocks: {launches}")
    if agg["plans_resumed"] < 1:
        raise AssertionError(f"serving resumed no plan: {agg}")
    if snap.watchdog_overruns or snap.retries or snap.timeouts:
        raise AssertionError(f"the fault-free stream overran or retried: {snap}")
    if final.submitted != final.resolved:
        raise AssertionError(f"unresolved requests: {final}")
    card = card_line()
    lat = snap.latency
    log(f"serving ({card}): deadline {SERVE_DEADLINE_MS:.0f} ms per request, "
        f"2 replicas, max_batch {SERVE_BATCH}; {SERVE_REQUESTS} requests in "
        f"{wall:.3f}s = {SERVE_REQUESTS / wall:.2f} req/s, submit-to-result "
        f"p50 {statistics.median(totals):.1f} ms, p99 "
        f"{statistics.quantiles(totals, n=100, method='inclusive')[98]:.1f} ms, max "
        f"{max(totals):.1f} ms; ServeMetrics over the whole fault-free stream "
        f"({n_stream} requests, mutations included; bucket upper edges): p50 "
        f"{lat['p50_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms, mean "
        f"{lat['mean_ms']:.1f} ms")
    log(f"serving ({card}): {waves}")
    log(f"serving outcomes ({card}): fault-free stream completed "
        f"{snap.completed}, shed {dict(snap.shed)}, errors {snap.errors}, "
        f"timeouts {snap.timeouts}, watchdog overruns {snap.watchdog_overruns}; "
        f"with faults: completed {final.completed}, errors {final.errors}, "
        f"retries {final.retries}, timeouts {final.timeouts}")
    log(f"serving plans ({card}): engines {agg['engine_counts']}, batches per "
        f"replica {agg['batches_per_replica']}, plans built {agg['plan_builds']}, "
        f"resumed {agg['plans_resumed']}, cold-invalidated "
        f"{agg['plan_invalidations']}; launches {launches}")
    for name in ("r0", "r1"):
        log(f"serving health events of {name} ({card}): " + ("; ".join(
            f"{e['event']}" + (f" ({e['detail'][:60]})" if e["detail"] else "")
            for e in events if e["replica"] == name) or "none"))
    log(f"serving peak device memory ({card}): {max_allocated()} bytes; phase "
        f"5 seconds: {time.perf_counter() - t_phase:.1f}")
    del db
    free_card()


# --------------------------------------------------------------------- #
# phase 4: kernels at the main path's shapes, and their times
# --------------------------------------------------------------------- #
def phase_kernel_times(db, runs, launches):
    import torch

    from repro_torch.engine import canonicalize
    from repro_torch.core import sparql
    from repro_torch.kernels.segsum import kernel, ref

    plans = []
    for name, texts in workload():
        for part in sparql.union_split(sparql.parse(texts[0])):
            plan, _ = db._engine.plan_for(canonicalize(part),
                                          bucket=len(texts))
            plans.append((name, plan))
    max_err = 0
    for _, plan in plans:  # every operator of every plan, at its own shape
        ops, n = plan.operands, plan.n_nodes
        for m in range(len(ops.seg_win)):
            args = (ops.init_packed, ops.seg_src_b[m], ops.seg_dst_b[m],
                    ops.seg_win[m])
            max_err = max(max_err, check_segor(args, n))
    log(f"segor kernel == plain version on every main-path operator "
        f"({sum(len(p.operands.seg_win) for _, p in plans)} operators)")
    # time the largest operator of the 16-request microbatch plan
    plan = plans[0][1]
    ops, n = plan.operands, plan.n_nodes
    m = max(range(len(ops.seg_win)), key=lambda i: ops.seg_src_b[i].shape[0])
    args = (ops.init_packed, ops.seg_src_b[m], ops.seg_dst_b[m], ops.seg_win[m])
    v, nw = args[0].shape
    g, be = args[1].shape
    ms = median_ms(lambda: kernel.segor_blocks(*args, num_segments=n))
    plain_ms = median_ms(lambda: ref.segor_blocks_ref(*args, num_segments=n))
    ms_again = median_ms(lambda: kernel.segor_blocks(*args, num_segments=n))
    bytes_moved = g * be * 8 + g * 4 + 2 * v * nw * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    log(f"segor_blocks at V={v}, nw={nw}, G={g}, BE={be}: kernel {ms:.4f} ms "
        f"(again {ms_again:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bytes_moved} bytes at 3.35 TB/s), "
        f"library_ms: null")
    for name, (res, cold, warm, n_launch, stages) in runs.items():
        split = ", ".join(f"{k} {v:.4f}s" for k, v in sorted(stages.items()))
        log(f"query {name}: requests {len(res)}, batch {res[0].batch}, "
            f"sweeps {res[0].sweeps}, cold {cold:.4f}s, warm {warm:.4f}s "
            f"({split}), segor launches (cold run) {n_launch}")
    log(device_share(db, workload()[0][1]))
    return [{
        "name": "segor_blocks", **KERNELS["segor_blocks"],
        "launches": launches.get("segor_blocks", 0),
        "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
    }]


def device_share(db, texts) -> str:
    """Device busy time over one warm run of ``texts``, from a profiler
    trace: the sum of the kernels' own device time against the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    db.execute_many(texts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        db.execute_many(texts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return trace_share(prof, wall)


def trace_share(prof, wall: float) -> str:
    """Device busy time in a profiler trace (the sum of the events' own
    device time) against the wall time it covered."""
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()) / 1e6
    if busy <= 0.0:
        return "device idle share: not measured (the trace shows no device time)"
    top = sorted(prof.key_averages(),
                 key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:4]
    names = ", ".join(
        f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}ms" for e in top)
    return (f"device busy {busy * 1e3:.3f} ms of {wall * 1e3:.1f} ms wall "
            f"(profiled warm run, idle share {1 - busy / wall:.4f}); "
            f"top kernels: {names}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--universities", type=int, default=8000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    log(f"phase 1: {card_line()}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    torch.zeros(1, device="cuda")  # create the context outside any timing
    seconds = _build.build()
    for name, s in seconds.items():
        log(f"built {name} in {s:.1f}s: {_build.library_path(name).name}")
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")
    log(f"phase 2: segor kernel == plain version on "
        f"{phase_kernel_cases(args.seed)} random cases")
    cases, err = phase_segsum_cases(args.seed)
    log(f"phase 2b: segsum kernel == plain version on {cases} random cases "
        f"(max err {err:.3g}), the same bits on every second launch")
    graph = load_corpus(args.universities, args.seed)
    segsum_record = phase_segsum_full(graph, args.seed)
    log("phase 3: main path")
    db, runs, launches = phase_main_path(graph)
    phase_cross_checks(graph, runs)
    log("phase 5: serving")
    phase_serving(graph, args.universities, args.seed)
    dense_records = phase_dense_tier(args.seed)
    log("phase 4: kernels at main-path shapes")
    records = (phase_kernel_times(db, runs, launches) + dense_records
               + [segsum_record])
    log(f"total {time.perf_counter() - t_start:.1f}s")
    log(card_line())
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
