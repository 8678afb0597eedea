"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` takes a :class:`Cell` (found by name from ``BENCHMARK.json``
and the files under ``dsbench/``), generates the corpus and the requests
from the seed, builds ``repro_torch``'s ``GraphDB`` and starts its
``AsyncServer``, warms every plan the window reaches on every replica,
drives the mix's closed loop of clients through ``AsyncServer.submit`` for
the window, waits for the answers still due, judges a seeded sample of them
against :mod:`dsbench.reference.dualsim`, and returns the result line.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import importlib
import importlib.util
import itertools
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

from dsbench import traffic, traced
from dsbench.reference import dualsim as ref

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
GRACE_S = 60.0  # how long answers still due at the window's end are awaited


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    mix: dict
    check: dict  # dsbench/workloads/<name>.json
    metrics: dict[str, list[dict]]  # "end_to_end" / "per_layer" -> the cell's entries


def find_cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell ``name``, with its configuration, mix, check settings and
    the metrics it reports, all found by name."""
    bm = benchmark if benchmark is not None else _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bm["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    # an end-to-end metric without ``workloads`` is every cell's; every
    # per-layer metric names the cells it reads something in
    e2e = [m for m in bm["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    layer = [m for m in bm["per_layer"] if name in m["workloads"]]
    return Cell(
        name=name,
        chips=entry["chips"],
        config=_json(BENCH / "configs" / f"{entry['config']}.json"),
        mix=_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        check=_json(BENCH / "workloads" / f"{name}.json"),
        metrics={"end_to_end": e2e, "per_layer": layer},
    )


def reader(metric: str):
    """The ``read(run)`` function of ``dsbench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"dsbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Record:
    """One request of the window."""

    index: int
    family: str
    text: str
    checked: bool
    t_submit: float = math.nan
    t_done: float | None = None
    outcome: str = "open"
    queue_ms: float = math.nan
    service_ms: float = math.nan  # the wall time of the batch it rode in
    replica: str = ""
    sweeps: int = 0
    engine: str = ""
    microbatch: tuple | None = None  # riders of one solve share this key
    n_survivors: int = 0
    survivors: np.ndarray | None = None
    bindings: dict | None = None

    @property
    def latency_ms(self) -> float:
        """Submit to answer; a request that failed or never came is ``inf``."""
        if self.outcome != "ok" or self.t_done is None:
            return math.inf
        return (self.t_done - self.t_submit) * 1e3


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read."""

    cell: Cell
    setup_s: float
    window_s: float
    t_end: float  # the window's end: the first answer at or after its nominal end
    records: list[Record]
    stages: dict[str, float]  # stage seconds over the window and its tail
    plan_builds: int
    n_nodes: int
    label_edges: dict[str, int]
    systems: dict[str, ref.System]  # query text -> the reference's SOI
    summary: traced.Summary | None = None
    process_cores: float = math.nan  # CPU seconds over host seconds, window and tail

    @property
    def answered(self) -> list[Record]:
        return [r for r in self.records if r.outcome == "ok"]


def _engine_totals(server, db) -> tuple[dict[str, float], int]:
    """Stage seconds and plan builds summed over the front end's engine and
    every replica."""
    stage: dict[str, float] = {}
    builds = 0
    for m in [db.stats(), *server.router.stats()]:
        for k, v in m.stage_seconds.items():
            stage[k] = stage.get(k, 0.0) + v
        builds += m.plan_builds
    return stage, builds


def _cpu_times() -> tuple[float, float]:
    """The host clock and this process's CPU seconds."""
    t = os.times()
    return time.perf_counter(), t.user + t.system


def _warm(server, requests: traffic.Requests) -> None:
    """Build every (template, bucket) plan the window reaches on every
    replica, then run each warm request once on each replica, so kernels are
    built and every layer has run before the window."""
    import threading

    def one(rep):
        eng = rep.engine
        prepared = [eng.prepare(text) for _, text in requests.warm]
        buckets = ([b for b in eng.buckets if b <= server.max_batch]
                   if requests.warm_all_buckets else [1])
        for _, inst in prepared:
            for b in buckets:
                eng.plan_for(inst, b)
        eng.execute_prepared(prepared)

    errors = []

    def guarded(rep):
        try:
            one(rep)
        except BaseException as exc:  # re-raised on the caller's thread
            errors.append(exc)

    threads = [threading.Thread(target=guarded, args=(r,)) for r in server.router.replicas]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _fill(rec: Record, res) -> None:
    rec.outcome = res.outcome
    rec.queue_ms, rec.service_ms, rec.replica = res.queue_ms, res.service_ms, res.replica or ""
    if not res.ok:
        return
    rs = res.result
    t = rs.timings
    rec.sweeps, rec.engine = rs.sweeps, rs.engine
    rec.microbatch = (rs.template_keys, rs.batch, rs.sweeps, t.get("solve"), t.get("batch_total"))
    rec.n_survivors = rs.stats.n_after
    if rec.checked:
        rec.survivors = rs.survivor_mask
        rec.bindings = {v: rs.binding_mask(v) for v in rs.variables}


async def _drive(server, requests, records, n_clients, seconds, grace_s, checked):
    """The closed loop: each client sends its next request once the last
    is answered, until the window closes; then the answers still due are
    awaited for up to ``grace_s``."""
    counter = itertools.count()
    t_start = time.perf_counter()
    t_end = t_start + seconds

    async def client():
        while time.perf_counter() < t_end:
            i = next(counter)
            fam, text = requests.window[i % len(requests.window)]
            rec = Record(i, fam, text, checked[i % len(checked)])
            records.append(rec)
            rec.t_submit = time.perf_counter()
            res = await server.submit(text)
            rec.t_done = time.perf_counter()
            _fill(rec, res)

    tasks = [asyncio.get_running_loop().create_task(client()) for _ in range(n_clients)]
    await asyncio.sleep(max(0.0, t_end - time.perf_counter()))
    _, pending = await asyncio.wait(tasks, timeout=grace_s)
    for t in pending:
        t.cancel()
    for t in tasks:
        try:
            await t
        except asyncio.CancelledError:
            pass
    return t_start, t_end


def check_sample(records, rng, cap) -> list[Record]:
    """The answered requests marked for the check, at most ``cap``: the
    first of each family always, the rest drawn from the seed."""
    pool = [r for r in records if r.checked and r.outcome == "ok"]
    first: dict[str, Record] = {}
    for r in sorted(pool, key=lambda r: r.index):
        first.setdefault(r.family, r)
    rest = [r for r in pool if first[r.family] is not r]
    keep = list(first.values())
    if len(keep) < cap and rest:
        pick = rng.permutation(len(rest))[: cap - len(keep)]
        keep += [rest[i] for i in sorted(pick.tolist())]
    return sorted(keep, key=lambda r: r.index)


def make_inputs(cell: Cell, seed: int):
    """The corpus, the request sequence, which requests the check may take,
    and the check's random stream, all from ``seed``: the same seed gives the
    same inputs."""
    data_ss, traffic_ss, check_ss = np.random.SeedSequence(abs(int(seed))).spawn(3)
    cfg = cell.config
    gen = importlib.import_module(f"dsbench.data.{cfg['generator']}")
    corpus = gen.generate(cfg, np.random.default_rng(data_ss))
    requests = traffic.generate(cell.mix, cfg, corpus, np.random.default_rng(traffic_ss))
    check_rng = np.random.default_rng(check_ss)
    checked = check_rng.random(len(requests.window)) < cell.check["check_share"]
    first: set[str] = set()
    for i, (fam, _) in enumerate(requests.window):  # every family is checked
        if fam not in first:
            first.add(fam)
            checked[i] = True
    return corpus, requests, checked, check_rng


def reference_data(corpus) -> ref.Data:
    """The reference's view of the corpus: the benchmark's own triples and
    dictionaries, never the program's."""
    return ref.Data(corpus.triples, corpus.n_nodes,
                    {n: i for i, n in enumerate(corpus.node_names)},
                    {n: i for i, n in enumerate(corpus.label_names)})


def judge(sample: list[Record], data: ref.Data) -> int:
    """Bits by which the sample's answers differ from the reference's:
    survivor triples and every variable's candidates; a variable missing
    from an answer counts all its reference bits and one more."""
    bad = 0
    for r in sample:
        mask, binds = ref.answer(r.text, data)
        bad += int(np.count_nonzero(mask != r.survivors))
        for var, row in binds.items():
            got = r.bindings.get(var)
            bad += int(row.sum()) + 1 if got is None else int(np.count_nonzero(got != row))
    return bad


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: float | None = None,
             log=print) -> tuple[dict, list[tuple[str, float, float]]]:
    """Run ``cell`` once; returns (the result line as a dict, the compared
    numbers as (name, value, limit))."""
    import torch

    from repro_torch.core.graph import Graph
    from repro_torch.db import GraphDB
    from repro_torch.serve import AsyncServer

    t0 = t_process if t_process is not None else time.perf_counter()
    steps = [("imports", time.perf_counter())]
    corpus, requests, checked, check_rng = make_inputs(cell, seed)
    steps.append(("corpus and requests", time.perf_counter()))
    log(f"corpus {cell.config['name']}: "
        + ", ".join(f"{k} {v}" for k, v in corpus.counts.items()))
    mix = cell.mix

    g = Graph.from_arrays(corpus.n_nodes, len(corpus.label_names), corpus.triples.copy())
    g.node_names, g.label_names = list(corpus.node_names), list(corpus.label_names)
    db = GraphDB(g, device=device)
    steps.append(("database", time.perf_counter()))
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        spans = traced.Spans()
        spans.wrap_layers()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)

    records: list[Record] = []
    marks: list[int] = []  # the host clock at the traced window's start

    async def main():
        server = AsyncServer(db, **mix["server"])
        await server.start()
        try:
            loop = asyncio.get_running_loop()
            steps.append(("server", time.perf_counter()))
            await loop.run_in_executor(None, _warm, server, requests)
            steps.append(("warm plans on every replica", time.perf_counter()))
            warm = await asyncio.gather(*[server.submit(t) for _, t in requests.warm])
            steps.append(("warm requests through the server", time.perf_counter()))
            if not all(r.ok for r in warm):
                raise RuntimeError(f"a warm request failed: {[r.detail for r in warm]}")
            if device == "cuda":
                torch.cuda.synchronize()
            gc.collect()
            before = _engine_totals(server, db)
            cpu_before = _cpu_times()
            if trace:
                prof.start()
                rf = record_function(traced.WINDOW)
                rf.__enter__()
                marks.append(time.perf_counter_ns())
            t_start, t_end = await _drive(server, requests, records, mix["clients"],
                                          seconds, GRACE_S, checked)
            if trace:
                if device == "cuda":
                    torch.cuda.synchronize()
                rf.__exit__(None, None, None)
                prof.stop()
            cpu.extend([cpu_before, _cpu_times()])
            after = _engine_totals(server, db)
        finally:
            await server.stop()
        return t_start, t_end, before, after

    cpu: list = []  # (host clock, CPU seconds) at the window's start and after its tail
    t_start, t_end, before, after = asyncio.run(main())
    setup_s = t_start - t0
    prev = t0
    parts = []
    for name, t in steps + [("the rest", t_start)]:
        parts.append(f"{name} {t - prev:.2f}s")
        prev = t
    log("set-up: " + ", ".join(parts))
    peak = torch.cuda.max_memory_allocated(0) if device == "cuda" else 0
    summary = None
    if trace:
        summary = traced.summarize(prof.profiler.kineto_results.events(), spans, marks[0])
        del prof
    del db, g
    gc.collect()

    # the check, after the window and with the program's state released
    t_check = time.perf_counter()
    data = reference_data(corpus)
    sample = check_sample(records, check_rng, cell.check["check_max"])
    mismatched = judge(sample, data)
    check_s = time.perf_counter() - t_check

    # the window closes on an answer: riders of one microbatch are answered
    # at one instant, so a fixed end would count whole batches or none
    t_close = min((r.t_done for r in records if r.outcome == "ok" and r.t_done >= t_end),
                  default=t_end)
    failed = [r for r in records if r.outcome not in ("ok", "open")]
    unanswered = [r for r in records if r.outcome == "open"]
    systems = {r.text: ref.build(ref.parse(r.text)) for r in records if r.outcome == "ok"}
    run = Run(
        cell=cell, setup_s=setup_s, window_s=t_close - t_start,
        t_end=t_close, records=records,
        stages={k: after[0].get(k, 0.0) - before[0].get(k, 0.0) for k in after[0]},
        plan_builds=after[1] - before[1], n_nodes=corpus.n_nodes,
        label_edges={a: data.edge_count(a) for a in corpus.label_names},
        systems=systems, summary=summary,
        process_cores=(cpu[1][1] - cpu[0][1]) / (cpu[1][0] - cpu[0][0]),
    )
    _log_run(run, log, len(sample), check_s, requests)
    checks = [("mismatched_bits", float(mismatched), 0.0),
              ("failed_requests", float(len(failed)), 0.0),
              ("unanswered_requests", float(len(unanswered)), 0.0)]
    metrics = {}
    for m in cell.metrics["per_layer" if trace else "end_to_end"]:
        v = reader(m["name"])(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {
        "correct": all(v <= lim for _, v, lim in checks) and bool(sample),
        "attempted": len(records),
        "failed": len(failed) + len(unanswered),
        "metrics": metrics,
        "device": device_info,
    }
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        top = sorted(summary.device_s.items(), key=lambda kv: -kv[1])[:10]
        top = [(k if len(k) <= 120 else k[:117] + "...", v) for k, v in top]
        line["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                             "idle_gaps": [[k, v] for k, v in summary.idle_gaps]}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line, checks


def _log_run(run: Run, log, n_checked: int, check_s: float, requests) -> None:
    by_family: dict[str, list[Record]] = {}
    for r in run.answered:
        by_family.setdefault(r.family, []).append(r)
    for fam, rs in sorted(by_family.items()):
        engines = sorted({r.engine for r in rs})
        sweeps = sorted({r.sweeps for r in rs})
        surv = sorted(r.n_survivors for r in rs)
        log(f"family {fam}: {len(rs)} answered, engine {','.join(engines)}, sweeps "
            f"{sweeps[0]}-{sweeps[-1]}, survivors median {surv[len(surv) // 2]} "
            f"(min {surv[0]}, max {surv[-1]})")
    n_in = sum(1 for r in run.answered if r.t_done <= run.t_end)
    wrapped = max((r.index for r in run.records), default=0) >= len(requests.window)
    log(f"requests: {len(run.records)} sent in the window, {n_in} answered in it, "
        f"{len(run.answered) - n_in} after it, "
        f"{sum(r.outcome not in ('ok', 'open') for r in run.records)} failed, "
        f"{sum(r.outcome == 'open' for r in run.records)} open at the end"
        + ("; the request sequence wrapped" if wrapped else ""))
    batches: dict[tuple, list[Record]] = {}
    for r in run.answered:  # the riders of one served batch share its replica and wall time
        batches.setdefault((r.replica, r.service_ms), []).append(r)
    for rep in sorted({k[0] for k in batches}):
        mine = [rs for k, rs in batches.items() if k[0] == rep]
        log(f"replica {rep or '?'}: {len(mine)} batches, {sum(map(len, mine))} requests, "
            f"busy {sum(rs[0].service_ms for rs in mine) / 1e3:.2f}s of the window and its "
            f"tail; riders a batch {min(map(len, mine))}-{max(map(len, mine))}, families a "
            f"batch {min(len({r.family for r in rs}) for rs in mine)}-"
            f"{max(len({r.family for r in rs}) for rs in mine)}")
    log(f"cores this process kept busy from the window's start to its last answer: "
        f"{run.process_cores:.2f}")
    t0 = run.t_end - run.window_s
    per10 = np.bincount([int((r.t_done - t0) // 10) for r in run.answered if r.t_done <= run.t_end])
    log(f"answers per 10 s of the window: {per10.tolist()}")
    log(f"check: {n_checked} answers against the reference in {check_s:.2f}s; "
        f"set-up {run.setup_s:.2f}s, window {run.window_s:.2f}s")


def loaded_jax_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that belong to JAX or the JAX
    package, compared whole."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)
