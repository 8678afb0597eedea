"""Async dual-simulation query serving driver — on the `repro_torch.serve` loop.

Drives a stream of constant-parameterized query-template instances through
:class:`repro_torch.serve.AsyncServer` (DESIGN.md Sect. 10): requests from
``--tenants`` synthetic tenants are admitted into a bounded queue, batched
by the real flush timer, scheduled deficit-round-robin across tenants, and
executed on ``--replicas`` engine replicas over immutable snapshots.  The
query shape is compiled ONCE per (bucket, replica) into a cached plan;
every subsequent request rebinds constants as inputs of the plan's
fixpoint, without building its operands again.  Requests that cannot be
served in time are shed with explicit outcomes instead of queueing without
bound.

With ``--mutate``, the driver mutates mid-stream to show both invalidation
classes (DESIGN.md Sect. 8) flowing through the replica pool: a
shape-stable delete/re-insert churn whose superseded plans are patched in
place and warm-resumed, then a dictionary-growing insert whose plans
rebuild cold; the metrics lines split the counts accordingly.

``--device`` picks where every replica's operands live and its fixpoints
run: ``cuda`` (the default; the kernels build with ``nvcc`` on first use)
or ``cpu`` (the plain torch versions)::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mutate
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 64 --batch 16

With ``--engine partitioned --devices N`` every replica's fixpoint splits
chi's node axis over a mesh of N devices (DESIGN.md Sect. 7): N simulated
shards of the host with ``--device cpu``, the first N cards with
``--device cuda`` (which raises if there are fewer)::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --engine partitioned --devices 4 --mutate
"""
from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np

from repro_torch.data import synth
from repro_torch.db import GraphDB
from repro_torch.distributed import ctx as dctx
from repro_torch.engine.cost import ENGINES
from repro_torch.serve import AsyncServer

QUERY = "{{ ?d subOrganizationOf {uni} . ?s memberOf ?d }}"


async def _serve(args, db: GraphDB, requests: list[str], churn) -> None:
    async with AsyncServer(
        db,
        replicas=args.replicas,
        max_queue=args.max_queue,
        max_batch=args.batch,
        max_delay_ms=args.max_delay_ms,
        default_deadline_ms=args.deadline_ms,
    ) as server:
        t_all = time.monotonic()
        futs = [
            server.submit(q, tenant=f"t{i % args.tenants}")
            for i, q in enumerate(requests)
        ]
        results = await asyncio.gather(*futs)

        if args.mutate:
            # shape-stable churn: delete + re-insert an existing triple —
            # superseded replica plans are *resumable* (patched in place,
            # the next solve warm-starts from the previous fixpoint)
            db.delete(churn)
            mid = await asyncio.gather(*[
                server.submit(q, tenant=f"t{i % args.tenants}")
                for i, q in enumerate(requests[: args.batch])
            ])
            db.insert(churn)
            # dictionary-growing insert: the classic *cold* invalidation
            db.insert([("DeptNew", "subOrganizationOf", "Univ0"),
                       ("StudentNew", "memberOf", "DeptNew")])
            await server.fence()  # every replica adopts the new epoch
            mid += await asyncio.gather(*[
                server.submit(q, tenant=f"t{i % args.tenants}")
                for i, q in enumerate(requests[: args.batch])
            ])
            results += mid
        total = time.monotonic() - t_all

        done = [r for r in results if r.ok]
        for i in range(0, len(done), args.batch):
            chunk = done[i:i + args.batch]
            r = chunk[0].result
            print(
                f"batch of {len(chunk)}: {r.sweeps} sweeps, "
                f"{chunk[0].service_ms:.1f} ms service "
                f"(replica {chunk[0].replica}), engine={r.engine}, "
                + ", ".join(f"{len(x.result)}/{x.result.stats.n_triples}"
                            for x in chunk[:4])
                + (" ... triples survive" if len(chunk) > 4
                   else " triples survive")
            )

        snap = server.metrics.snapshot()
        agg = server.router.aggregate()
        shed = snap.shed_total
        print(
            f"served {snap.completed}/{len(results)} requests in {total:.2f}s "
            f"({snap.completed / total:.1f} req/s closed-loop), {shed} shed "
            f"{dict(snap.shed)}, queue peak {snap.queue_peak}, "
            f"p50 {snap.latency['p50_ms']:.1f} ms / "
            f"p99 {snap.latency['p99_ms']:.1f} ms"
        )
        print(
            f"tenants: "
            + ", ".join(f"{t}: {d['completed']}/{d['submitted']}"
                        for t, d in sorted(snap.per_tenant.items()))
            + f"; replicas: {agg['batches_per_replica']} batches"
        )
        print(
            f"plan cache: {agg['cache_hits']} hits / {agg['cache_misses']} "
            f"misses, {agg['plan_builds']} plans built, "
            f"{agg['plan_invalidations']} cold-invalidated (v{db.version}), "
            f"engines={agg['engine_counts']}"
        )
        if args.mutate:
            print(
                f"incremental maintenance: {agg['plans_resumable']} plans "
                f"reclassified resumable, {agg['plans_resumed']} patched + "
                f"resumed ({agg['warm_resume_solves']} warm-started solves, "
                f"{agg['resumes_declined']} declined), "
                f"{agg['adj_rebuilds_saved']} adjacency rebuilds saved"
            )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve template queries through repro_torch.serve.",
    )
    ap.add_argument("--batch", type=int, default=8,
                    help="max requests per dispatched microbatch")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-delay-ms", type=float, default=50.0,
                    help="flush timer: max wait for a partial batch")
    ap.add_argument("--replicas", type=int, default=2,
                    help="engine read replicas over the shared snapshots")
    ap.add_argument("--tenants", type=int, default=2,
                    help="synthetic tenants round-robined over the stream")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission bound: beyond this, requests shed")
    ap.add_argument("--deadline-ms", type=float, default=10_000.0,
                    help="per-request deadline (expired => shed, not run)")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", *ENGINES],
                    help="fixpoint engine; 'auto' = cost-based selection")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where operands live and fixpoints run; 'cuda' "
                         "raises without a card")
    ap.add_argument("--devices", type=int, default=0,
                    help="split over a mesh of this many devices (simulated "
                         "host shards with --device cpu, cards with --device "
                         "cuda); 0 = no mesh")
    ap.add_argument("--mutate", action="store_true",
                    help="mutate mid-stream: a shape-stable delete/re-insert "
                         "churn (warm-resumed plans) plus a dictionary-"
                         "growing insert (cold invalidation)")
    args = ap.parse_args(argv)

    mesh = None
    if args.devices > 1:
        mesh = dctx.node_mesh(args.devices, device=args.device)
    db = GraphDB(synth.lubm_like(n_universities=8, seed=0),
                 engine=args.engine, device=args.device, mesh=mesh)
    print(f"database: {db.n_triples} triples / {db.n_nodes} nodes on "
          f"{args.device}"
          + (f", mesh of {args.devices} devices" if mesh is not None else ""))

    unis = [n for n in db.graph.node_names if n.startswith("Univ")]
    rng = np.random.default_rng(0)
    requests = [
        QUERY.format(uni=unis[rng.integers(len(unis))])
        for _ in range(args.requests)
    ]

    churn = None
    if args.mutate:
        g = db.graph
        row = g.triples[0]
        churn = [(g.node_names[row[0]], g.label_names[row[1]],
                  g.node_names[row[2]])]

    asyncio.run(_serve(args, db, requests, churn))


if __name__ == "__main__":
    main()
