#!/usr/bin/env python3
"""Drive the torch port's query path on one NVIDIA card and check it.

    python3 chip_smoke.py [--universities 8000] [--seed 0]

Run from the repository root (the script puts ``src/`` on the path
itself).  It needs one CUDA card and ``nvcc``; without a card it exits
non-zero and prints no result.  Phases, in order, any failure fatal:

1. print the card (``nvidia-smi``), build every CUDA kernel from the
   sources in the checkout, in parallel;
2. hold each kernel against its plain PyTorch version on the card, on
   random edge cases, for exact equality of the words;
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
4. the kernels against their plain versions at the main path's own
   shapes, and their times (CUDA events, median of 25 launches) beside
   their bound.

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
KERNELS = {
    "segor_blocks": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/segsum/csrc/segor.cu",
        "replaces": "src/repro/kernels/segsum/kernel.py:222",
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


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
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


def serve(db, *, warm: bool = True):
    """Run the workload through ``db`` cold, then (``warm``) once more from
    the plan cache; returns {name: (results, cold_s, warm_s, launches,
    stages)}: ``launches`` counts the segor launches of the cold run,
    ``stages`` the engine's per-stage seconds of the warm run."""
    import torch

    from repro_torch import kernels

    on_card = db._engine.device.type == "cuda"
    out = {}
    for name, texts in workload():
        before = kernels.LAUNCHES.get("segor_blocks", 0)
        t0 = time.perf_counter()
        res = db.execute_many(texts)
        if on_card:
            torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = kernels.LAUNCHES.get("segor_blocks", 0) - before
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
    import numpy as np

    from repro_torch import kernels
    from repro_torch.db import GraphDB
    from repro_torch.engine import cost

    if cost.dense_tier_feasible(graph.n_nodes):
        raise AssertionError("corpus is within the dense tier; use more universities")
    db = GraphDB(graph)  # the default device: the card
    kernels.reset_launches()
    runs = serve(db)
    # shape-stable delete + re-insert of one triple, then the same requests
    row = graph.triples[int(np.flatnonzero(
        graph.triples[:, 1] == graph.label_id("memberOf"))[0])]
    t = tuple(n[i] for n, i in zip(
        (graph.node_names, graph.label_names, graph.node_names), row))
    texts = workload()[0][1]
    if db.delete([t]) != 1:
        raise AssertionError("delete of an existing triple removed nothing")
    t0 = time.perf_counter()
    after_delete = db.execute_many(texts)
    resume_delete = time.perf_counter() - t0
    if db.insert([t]) != 1:
        raise AssertionError("re-insert added nothing")
    t0 = time.perf_counter()
    after_insert = db.execute_many(texts)
    resume_insert = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    m = db.metrics()
    if m.plans_resumed < 1:
        raise AssertionError(f"no plan resumed after the mutation: {m}")
    if not launches.get("segor_blocks"):
        raise AssertionError("the main path never launched segor_blocks")
    for name, (res, *_rest) in runs.items():
        engines = {e for r in res for e in r.engine.split(",")}
        if engines != {"sparse"}:
            raise AssertionError(f"{name}: cost model chose {engines}")
    # the re-inserted graph equals the original up to triple order
    same_bindings = all(
        np.array_equal(a.binding_mask(v), b.binding_mask(v))
        for a, b in zip(after_insert, runs["serve_template_x16"][0])
        for v in a.variables
    )
    if not same_bindings or len(after_delete) != len(texts):
        raise AssertionError("answers after delete + re-insert changed")
    log(f"main path: engine=sparse, segor launches {launches}, "
        f"plans_resumed {m.plans_resumed}, warm_resume_solves "
        f"{m.warm_resume_solves}; resume after delete {resume_delete:.4f}s, "
        f"after insert {resume_insert:.4f}s")
    return db, runs, launches


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
    log("phase 3: main path")
    graph = load_corpus(args.universities, args.seed)
    db, runs, launches = phase_main_path(graph)
    phase_cross_checks(graph, runs)
    log("phase 4: kernels at main-path shapes")
    records = phase_kernel_times(db, runs, launches)
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
