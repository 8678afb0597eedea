"""Berkeley-ERT-style machine probe of the port → ``MachineSpec`` (DESIGN.md 13.1).

The torch twin of the JAX package's ``benchmarks/roofline.py``: the same
sweeps at the same sizes on the CPU, filling the same :class:`MachineSpec`
fields, so :func:`repro_torch.engine.cost.CostModel.from_spec` derives the
cost model's constants from a machine's own measurements instead of the
hand-tuned fallback.  On a card the bit-op and dense sweeps time the
port's own kernels at the dense tier's real shapes instead, since they do
other work than the reference's Pallas kernels.  Four sweeps, each a
micro-kernel the engines actually execute, best-of-N timed like ERT:

* **stream** — sustained memory bandwidth: an ``int32`` XOR pass (8 bytes
  moved a word) over working sets from cache-resident to HBM-resident (the
  segmented-OR sweep is this workload: packed chi planes and edge id
  streams).  Peak across sizes is the spec's ``stream_bytes_per_s``.
* **bitop** — ``bitmm_apply`` word throughput, under both lowerings the
  port has: ``shipping``, what plans run
  (:func:`repro_torch.kernels.bitmm.ops.bitmm_apply`: the CUDA kernel K2 on
  a card, its plain version on the CPU, which has no interpreter), and
  ``xla``, the word-wise plain version
  (:func:`repro_torch.kernels.bitmm.ref.bitmm_apply_ref`) on the same
  device.  On the CPU, as in the reference, the cheapest call gives the
  per-call overheads (``kernel_launch_s`` / ``dispatch_s``) and the best
  words/seconds the sustained rate.  On a card (:func:`card_bitop_rows`)
  K2 and the packed engine's step are timed at n up to 46,200, V from 3
  to 48 and frontier densities from 0.02 to 0.5, and each is fitted to
  ``seconds = launch + popcount(chi) * nw / rate``: K2's fit gives
  ``kernel_launch_s`` and ``fused_words_per_s``, the packed step's
  ``packed_words_per_s``; the ``xla`` rows and ``dispatch_s`` stay the
  reference's.
* **dense** — the dense engine's own boolean product, ``(x.to(f32) @
  a.to(f32)) > 0``, under whatever TF32 setting the caller runs the engine
  with (the probe changes no flag), giving ``dense_elems_per_s``; on a
  card at V from 3 to 48 and n up to 16,384, the product alone timed too
  (:func:`card_dense_rows`).
* **collective** — on two or more cards only: the partitioned engine's
  one cross-device transfer, the packed frontier's column shards copied
  onto every :func:`repro_torch.distributed.ctx.node_mesh` device, giving
  ``collective_bytes_per_s``; ``None`` on one device (and on the CPU).

Plus a **trace** probe: eager torch compiles nothing, so ``trace_s`` is the
port's fixed cold cost of the reference's packed fixpoint (see
:func:`trace_probe`), what the resume-versus-cold model charges a rebuild
beyond its sweeps.

Entry points run on the card unless the caller passes ``backend="cpu"``;
without a card ``backend="cuda"`` raises.  The CUDA libraries are built
before any timing.  The spec persists as versioned JSON under
``results/machine/`` through :func:`repro_torch.engine.machine.save_spec`,
where :func:`repro_torch.engine.machine.default_spec` (and so every
``Engine``) finds it; ``REPRO_MACHINE_SPEC`` governs that lookup as in
the JAX package.  ``--fast`` runs the reduced sweep (fewer sizes and
repeats: noisier, still valid calibration).

    PYTHONPATH=src python -m repro_torch.launch.roofline             # the card
    PYTHONPATH=src python -m repro_torch.launch.roofline --fast --backend cpu --no-save --json
"""
from __future__ import annotations

import argparse
import datetime
import json
import time

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.core.device import resolve_device
from repro_torch.engine import machine
from repro_torch.kernels.bitmm import ops as bitmm_ops, ref as bitmm_ref

# 0x9E3779B9, the reference's XOR constant, as its int32 bit-view
XOR_WORD = -1640531527


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_s(fn, repeats: int, dev: torch.device) -> float:
    """Best-of-N wall seconds of ``fn``, each call ended by a synchronise
    on a card (the first call, which loads the kernels, is untimed)."""
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def stream_probe(fast: bool = False, repeats: int | None = None,
                 backend: str = "cuda") -> dict:
    """Peak sustained streaming bandwidth over ``int32`` word traffic.

    Read + write one word per element (8 bytes moved per word): the traffic
    shape of the packed-chi planes and edge-id streams the segor sweep
    moves.  Every size's row is kept: on a card with a 50 MB L2 the two
    smaller sets (8 and 32 MiB moved) can be served from the cache, so the
    row that sets the peak says whether it is a memory number.
    """
    dev = resolve_device(backend)
    sizes = [1 << 20, 1 << 22] if fast else [1 << 20, 1 << 22, 1 << 24]
    repeats = repeats or (3 if fast else 5)
    rng = np.random.default_rng(0)
    rows = []
    for words in sizes:
        x = torch.from_numpy(
            rng.integers(0, 2**32, words, dtype=np.uint64).astype(np.uint32).view(np.int32)
        ).to(dev)
        t = _best_s(lambda: x ^ XOR_WORD, repeats, dev)
        rows.append(dict(words=words, seconds=t, bytes_per_s=8.0 * words / t))
    return dict(rows=rows, bytes_per_s=max(r["bytes_per_s"] for r in rows))


# The card's bit-op rows (K2, and the packed engine's step): n from the
# reference probe's largest size to the dense tier's largest graph
# (46,200 nodes), V from one small query's variables to the serving
# microbatch's 48, and frontier densities from sparse to half set.  The
# work unit is one OR'd word a set frontier bit and column word.
CARD_BITOP_NS = (4096, 16384, 46200)
CARD_BITOP_VS = (3, 16, 48)
CARD_DENSITIES = (0.02, 0.1, 0.5)
# the dense engine's operator step at V from 3 to 48 and n up to 16,384
CARD_DENSE_NS = (4096, 8192, 16384)
CARD_DENSE_VS = (3, 16, 48)
# edges a node of the probe's random operands (a row's cost depends on
# which rows the frontier selects, not on the bits a row holds)
EDGES_PER_NODE = 8


def _random_edges(n: int, gen: torch.Generator, dev: torch.device):
    """``EDGES_PER_NODE * n`` random (source, destination) pairs on ``dev``."""
    e = EDGES_PER_NODE * n
    return (torch.randint(0, n, (e,), generator=gen, device=dev),
            torch.randint(0, n, (e,), generator=gen, device=dev))


def packed_operand(n: int, gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    """``int32 [n, nw]`` packed adjacency of a random edge list, packed on
    ``dev`` as ``core/graph.py::Graph.packed_adjacency`` packs on the host:
    the unique (row, column) cells, then the distinct bits of each word
    combined (summed in ``int64``, which is their OR) and stored as the
    ``int32`` bit-view.  No ``[n, n]`` plane is made."""
    src, dst = _random_edges(n, gen, dev)
    cell = torch.unique(src * n + dst)
    rows, cols = cell // n, cell % n
    nw = bitops.packed_width(n)
    words = torch.zeros(n * nw, dtype=torch.int64, device=dev)
    words.index_add_(0, rows * nw + (cols >> 5),
                     torch.bitwise_left_shift(torch.ones_like(cols), cols & 31))
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).reshape(n, nw)


def fit_launch_rate(rows: list[dict]) -> tuple[float, float]:
    """``(launch, rate)`` of ``seconds = launch + work / rate`` over the
    rows, least squares on each row's relative residual (so the
    launch-bound rows weigh as much as the work-bound ones); ``launch``
    is held at 0 where the free fit puts it below, and ``rate`` falls back
    to the best row's ``work / seconds`` where no positive slope fits."""
    work = np.array([r["work"] for r in rows], dtype=np.float64)
    t = np.array([r["seconds"] for r in rows], dtype=np.float64)
    ones = np.ones_like(t)
    (launch, per_work), *_ = np.linalg.lstsq(
        np.stack([1.0 / t, work / t], 1), ones, rcond=None)
    if launch < 0:
        launch = 0.0
        (per_work,), *_ = np.linalg.lstsq((work / t)[:, None], ones, rcond=None)
    rate = 1.0 / per_work if per_work > 0 else float(np.max(work / t))
    return float(launch), float(rate)


def _fitted(rows: list[dict]) -> dict:
    """The rows with each one's fitted seconds, and the fit."""
    launch, rate = fit_launch_rate(rows)
    for r in rows:
        r["fit_seconds"] = launch + r["work"] / rate
    return dict(rows=rows, launch_s=launch, words_per_s=rate)


def card_bitop_rows(dev: torch.device, fast: bool, repeats: int) -> dict:
    """The card's rows: K2 (``bitmm_ops.bitmm_apply``, what the fused
    engine runs per operator) and the packed engine's per-operator step
    (K3 on a bool frontier, then the unpacked AND of ``solve_packed``'s
    ``_fixpoint``), each at every (n, V, density), each fitted to
    ``seconds = launch + work / rate`` with ``work = popcount(chi) * nw``."""
    from types import SimpleNamespace

    from repro_torch.core import dualsim

    ns = CARD_BITOP_NS[::2] if fast else CARD_BITOP_NS
    vs = CARD_BITOP_VS[::2] if fast else CARD_BITOP_VS
    densities = CARD_DENSITIES[::2] if fast else CARD_DENSITIES
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    fused, packed = [], []
    for n in ns:
        nw = bitops.packed_width(n)
        a = packed_operand(n, gen, dev)
        for v in vs:
            flags = (torch.rand((v, v), generator=gen, device=dev) < 0.5).to(torch.int32)
            # every variable under one inequality: l <= (l + 1) mod V
            ops = SimpleNamespace(
                mat_rhs=[torch.arange(v, device=dev)],
                mat_table=[((torch.arange(v, device=dev) + 1) % v)[:, None]])
            for d in densities:
                x = torch.rand((v, n), generator=gen, device=dev) < d
                chi = bitops.pack(x)
                row = dict(n=n, v=v, density=d, bits=int(x.sum()))
                row["work"] = row["bits"] * nw
                t = _best_s(lambda: bitmm_ops.bitmm_apply(chi, a, flags), repeats, dev)
                fused.append(dict(row, seconds=t))
                t = _best_s(lambda: dualsim._apply_mat(x, bitmm_ops.bitmm(x, a), 0, ops),
                            repeats, dev)
                packed.append(dict(row, seconds=t))
        del a
    return dict(fused=_fitted(fused), packed=_fitted(packed))


def bitop_probe(backend: str = "cuda", fast: bool = False,
                repeats: int | None = None) -> dict:
    """``bitmm_apply`` word throughput + per-call overheads, both lowerings.

    ``shipping`` is what plans run on this backend (the CUDA kernel on a
    card, its plain version on the CPU); ``xla`` is the word-wise plain
    version on the same device.  On the CPU, as in the reference, work per
    call is ``V * n * n/32`` word-ops (every output word ORs over all ``n``
    adjacency rows), the cheapest call bounds the per-call overhead and
    the best words/seconds across sizes is the sustained rate — max/min
    extraction, no launch subtraction.

    On a card ``shipping`` is instead the fit of :func:`card_bitop_rows`:
    K2's work follows the set frontier bits (rows no variable selects are
    never read), so its rows span the dense tier's shapes and are priced
    by ``popcount(chi) * nw``; ``launch_s`` is the fit's intercept and
    ``words_per_s`` its rate.  ``packed`` is the packed engine's step,
    fitted alike.  The ``xla`` rows stay the reference's on every backend.
    """
    dev = resolve_device(backend)
    repeats = repeats or (3 if fast else 5)
    v = 8
    rng = np.random.default_rng(1)
    ship_ns = [64, 512] if fast else [64, 256, 1024]
    xla_ns = [64, 1024, 2048] if fast else [64, 1024, 4096]

    def measure(ns, run):
        rows = []
        for n in ns:
            nw = bitops.packed_width(n)
            a = bitops.to_words(bitops.pack_np(rng.random((n, n)) < 0.01), dev)
            chi = bitops.to_words(bitops.pack_np(rng.random((v, n)) < 0.5), dev)
            flags = torch.as_tensor(rng.integers(0, 2, (v, v)).astype(np.int32), device=dev)
            t = _best_s(lambda: run(chi, a, flags), repeats, dev)
            rows.append(dict(n=n, seconds=t, words=v * n * nw))
        overhead = min(r["seconds"] for r in rows)
        words_per_s = max(r["words"] / r["seconds"] for r in rows)
        return dict(rows=rows, overhead_s=overhead, words_per_s=words_per_s)

    if dev.type == "cpu":
        ship = measure(ship_ns, bitmm_ops.bitmm_apply)
        xla = measure(xla_ns, bitmm_ref.bitmm_apply_ref)
        return dict(shipping=ship, xla=xla)
    card = card_bitop_rows(dev, fast, repeats)
    xla = measure(xla_ns, bitmm_ref.bitmm_apply_ref)
    return dict(shipping=card["fused"], packed=card["packed"], xla=xla)


def card_dense_rows(dev: torch.device, fast: bool, repeats: int) -> list[dict]:
    """The card's dense rows: at every (n, V), what ``solve_dense`` runs
    for one operator (``seconds``) and the product alone on the converted
    plane (``product_seconds``), each plane made on ``dev`` from a random
    edge list."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    ns = CARD_DENSE_NS[::2] if fast else CARD_DENSE_NS
    vs = CARD_DENSE_VS[::2] if fast else CARD_DENSE_VS
    rows = []
    for n in ns:
        src, dst = _random_edges(n, gen, dev)
        plane = torch.zeros((n, n), dtype=torch.bool, device=dev)
        plane[src, dst] = True
        plane_f = plane.to(torch.float32)
        for v in vs:
            x = torch.rand((v, n), generator=gen, device=dev) < 0.5
            step = _best_s(lambda: (x.to(torch.float32) @ plane.to(torch.float32)) > 0,
                           repeats, dev)
            product = _best_s(lambda: (x.to(torch.float32) @ plane_f) > 0, repeats, dev)
            rows.append(dict(n=n, v=v, seconds=step, product_seconds=product,
                             elems_per_s=v * n * n / step))
        del plane, plane_f
    return rows


def dense_probe(fast: bool = False, repeats: int | None = None,
                backend: str = "cuda") -> dict:
    """Boolean-matmul element throughput of the dense engine's product
    (``core/dualsim.py::solve_dense``), under the caller's TF32 setting.

    Each row times what ``solve_dense`` runs for one operator: both
    operands' f32 conversion, the product and ``> 0``; ``elems_per_s`` is
    the best row's ``V * n * n / seconds``, as in the reference.  The CPU
    keeps the reference's rows (V = 16, n up to 4,096).  A card's rows
    (:func:`card_dense_rows`) span V from 3 to 48 and n up to 16,384, and
    also time the product alone: the step minus the product is the plane's
    conversion, which does not shrink with V, and is what
    ``engine/cost.py`` prices in bytes at the stream rate.
    """
    dev = resolve_device(backend)
    repeats = repeats or (3 if fast else 5)
    if dev.type != "cpu":
        rows = card_dense_rows(dev, fast, repeats)
        return dict(rows=rows, elems_per_s=max(r["elems_per_s"] for r in rows))
    v = 16
    ns = [1024, 2048] if fast else [1024, 2048, 4096]
    rng = np.random.default_rng(2)
    rows = []
    for n in ns:
        x = torch.as_tensor(rng.random((v, n)) < 0.5, device=dev)
        a = torch.as_tensor(rng.random((n, n)) < 0.01, device=dev)
        t = _best_s(lambda: (x.to(torch.float32) @ a.to(torch.float32)) > 0, repeats, dev)
        rows.append(dict(n=n, seconds=t, elems_per_s=v * n * n / t))
    return dict(rows=rows, elems_per_s=max(r["elems_per_s"] for r in rows))


def collective_probe(backend: str = "cuda", fast: bool = False,
                     repeats: int | None = None) -> dict | None:
    """Per-byte cross-device cost over the visible cards; ``None`` below 2.

    The traffic the partitioned engine makes: the packed frontier's column
    shards, one on each device of a :func:`~repro_torch.distributed.ctx.
    node_mesh` over every card, copied whole onto every device (one
    process drives them all).  The measured bytes/s is the *payload* rate
    (one plane's bytes over the call's wall time) — an envelope for the
    comm terms, not a bisection-bandwidth claim.
    """
    from repro_torch.core import dualsim
    from repro_torch.distributed import ctx

    dev = resolve_device(backend)
    d = torch.cuda.device_count() if dev.type == "cuda" else 1
    if d < 2:
        return None
    repeats = repeats or (3 if fast else 5)
    words = 1 << 16 if fast else 1 << 18
    mesh = ctx.node_mesh(d, device=backend)
    plane = torch.arange(words, dtype=torch.int32).reshape(1, words)
    parts = tuple(p.to(dv) for p, dv in zip(torch.chunk(plane, d, dim=1), mesh.devices))

    def copy():
        out = dualsim._replicated_frontier(parts, list(mesh.devices))
        for dv in mesh.devices:
            torch.cuda.synchronize(dv)
        return out

    t = _best_s(copy, repeats, dev)
    payload = words * 4.0
    return dict(n_devices=d, words=words, seconds=t, bytes_per_s=payload / t)


def trace_probe(n: int = 2048, v: int = 8, sweeps: int = 8,
                backend: str = "cuda", repeats: int = 5) -> float:
    """The port's fixed cold cost of a packed fixpoint, in seconds.

    Eager torch has no jit trace or compile.  What a cold rebuild costs
    beyond its sweeps is the set-up of the reference's same fixpoint
    (packed chi, one fused ``bitmm_apply`` a step, at most ``sweeps`` steps
    with one convergence read each): uploading the packed adjacency and the
    flags from numpy, allocating chi, and the host loop's first run.  This
    returns that cold run's seconds less the fastest run of the same loop
    on the uploaded operands, the first run and ``repeats`` warm ones
    among them: at least the uploads' own seconds, never negative.  The
    kernel library is built and loaded before.
    """
    dev = resolve_device(backend)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.load("bitmm")
    rng = np.random.default_rng(3)
    a_np = bitops.pack_np(rng.random((n, n)) < 0.01)
    flags_np = rng.integers(0, 2, (v, v)).astype(np.int32)
    chi_np = bitops.pack_np(rng.random((v, n)) < 0.5)

    def fixpoint(chi, a, flags):
        for _ in range(sweeps):
            chi, changed = bitmm_ops.bitmm_apply(chi, a, flags)
            if not int(changed):
                break
        return chi

    _sync(dev)
    t0 = time.perf_counter()
    a = bitops.to_words(a_np, dev)
    flags = torch.from_numpy(flags_np).to(dev)
    chi = bitops.to_words(chi_np, dev)
    _sync(dev)
    t1 = time.perf_counter()
    fixpoint(chi, a, flags)
    _sync(dev)
    t2 = time.perf_counter()
    loops = [t2 - t1]
    for _ in range(repeats):
        t1 = time.perf_counter()
        fixpoint(chi, a, flags)
        _sync(dev)
        loops.append(time.perf_counter() - t1)
    return (t2 - t0) - min(loops)


def probe(fast: bool = False, backend: str = "cuda"):
    """Run every sweep; returns ``(MachineSpec, per-sweep detail dict)``."""
    dev = resolve_device(backend)
    cuda = dev.type == "cuda"
    if cuda:
        from repro_torch.kernels import _build

        _build.build()
    stream = stream_probe(fast, backend=backend)
    bitop = bitop_probe(backend, fast)
    dense = dense_probe(fast, backend=backend)
    coll = collective_probe(backend, fast)
    trace_s = trace_probe(1024 if fast else 2048, backend=backend)
    ship_wps = bitop["shipping"]["words_per_s"]
    xla_wps = bitop["xla"]["words_per_s"]
    spec = machine.MachineSpec(
        backend=backend,
        device_kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        fingerprint=machine.machine_fingerprint(backend),
        n_devices=torch.cuda.device_count() if cuda else 1,
        stream_bytes_per_s=stream["bytes_per_s"],
        dense_elems_per_s=dense["elems_per_s"],
        # on a card the rates and the launch are the fits of the port's own
        # kernels; the fused engine ships the words lowering on the CPU
        packed_words_per_s=bitop["packed"]["words_per_s"] if cuda else ship_wps,
        packed_words_per_s_xla=xla_wps,
        fused_words_per_s=ship_wps if cuda else xla_wps,
        kernel_launch_s=(bitop["shipping"]["launch_s"] if cuda
                         else bitop["shipping"]["overhead_s"]),
        dispatch_s=bitop["xla"]["overhead_s"],
        trace_s=trace_s,
        collective_bytes_per_s=coll["bytes_per_s"] if coll else None,
        probed_at=datetime.datetime.now(datetime.timezone.utc).isoformat(),
        fast=fast,
    )
    detail = dict(stream=stream, bitop=bitop, dense=dense, collective=coll, trace_s=trace_s)
    return spec, detail


def main(argv: list[str] | None = None) -> int:
    """CLI: run the probe, print the spec, persist under ``results/machine/``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="reduced CI sweep (fewer sizes/repeats)")
    ap.add_argument("--no-save", action="store_true",
                    help="print only; do not persist the spec")
    ap.add_argument("--json", action="store_true",
                    help="dump the spec as JSON to stdout")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"),
                    help="device type to probe (default: the card)")
    args = ap.parse_args(argv)
    spec, _ = probe(fast=args.fast, backend=args.backend)
    if args.json:
        print(json.dumps(spec.to_json(), indent=1, sort_keys=True))
    else:
        for k, v in sorted(spec.to_json().items()):
            print(f"machine/{k},{v}")
    if not args.no_save:
        path = machine.save_spec(spec)
        print(f"# saved {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
