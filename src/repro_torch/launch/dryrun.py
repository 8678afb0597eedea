"""Production dry-run: trace every (architecture x shape x mesh) cell's step
on abstract state, sharded over a production mesh, and account for it per
device: memory, FLOPs, bytes and collective bytes, and the roofline terms
they give.

No card is used, as the JAX package's dry-run uses no TPU: the state and
the inputs are fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage), placed as DTensors over the 16x16 (or 2x16x16) mesh of the fake
process group (:mod:`repro_torch.launch.mesh`), in which this process is
rank 0 and no collective moves data.  The step runs once under the
logical-axis rules (:func:`repro_torch.distributed.ctx.logical_axis_rules`),
and one dispatch mode below DTensor sees every operation a device runs:

* FLOPs and bytes are counted on the *local* shards (``FlopCounterMode``
  on DTensors would count the global product): a product's FLOPs by
  ``torch.utils.flop_counter``'s formulas, an elementwise operation's one
  per output element, a reduction's one per input element; bytes are each
  operation's inputs read and outputs written (a gather's or a scatter's
  rows, not its whole table), with no fusion;
* collective bytes are the output bytes of the functional collectives
  (``_c10d_functional``) the DTensor redistributions and the shard-local
  code issue, as the JAX package counts a collective's output shape; an
  all-to-all in which a rank hears from one source
  (``funcol.permute_tensor``) is a ``collective-permute``, as XLA names
  it.  On a CPU mesh DTensor runs
  an all-to-all (``Shard(i)`` to ``Shard(j)`` on one mesh dim) as an
  all-gather of the whole and a chunk; :func:`counted_alltoall` counts
  each such call as one all-to-all of the local shard's bytes instead, and
  the record says how often it ran (``alltoall_fallbacks``);
* memory is the bytes of the state's and the inputs' shards, plus the
  peak of what the step allocates on top (outputs included).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dcn-v2 --cell train_batch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multipod
Results are written to results/dryrun_torch/<arch>__<cell>__<mesh>.json;
existing results are skipped unless --force.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import configs
from repro_torch.distributed import shard as sh
from repro_torch.distributed.ctx import logical_axis_rules
from repro_torch.launch import mesh as mesh_mod

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../results/dryrun_torch")

# NVIDIA H100 80GB HBM3 (SXM), 700.00 W: published figures (data sheet).
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # B/s per card
# A 16x16 mesh spans 32 nodes of 8 NVLink-connected cards, so a collective
# over a mesh axis leaves the node: the bound is each card's InfiniBand NDR
# port, 400 Gb/s = 50 GB/s a direction (NVLink 4 inside a node: 450 GB/s).
LINK_BW = 50e9  # B/s per card

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "wait_tensor"}
# a gather reads its indices and the rows it takes, not its whole table; a
# scatter in place reads and writes the rows it touches
_GATHERS = {"index", "index_select", "gather", "embedding"}
_SCATTERS = {"index_put_", "_index_put_impl_", "index_add_", "scatter_add_",
             "scatter_reduce_", "scatter_"}
# a factory writes its output and reads nothing
_FACTORIES = {"zeros", "ones", "full", "arange", "zeros_like", "ones_like", "full_like",
              "new_zeros", "new_ones", "new_full", "scalar_tensor", "lift_fresh_copy"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Pause:
    """Context manager that stops an :class:`Account` counting while open."""

    def __init__(self, account: "Account"):
        self.account = account

    def __enter__(self):
        self.account.paused += 1

    def __exit__(self, *exc):
        self.account.paused -= 1


class Account(TorchDispatchMode):
    """Counts what one device runs: an operation on DTensors is handed on
    (``NotImplemented``) to DTensor, whose local operations and collectives
    come back through this mode on plain tensors, and are counted there.
    DTensor's sharding propagation also runs each new operation once on
    global-shape fake tensors to learn the output's shape; that run is not
    the device's, and :meth:`paused` keeps it out."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, float] = {}
        self.paused = 0
        self.alltoall_fallbacks = 0
        self.live = 0
        self.peak = 0
        self._seen: weakref.WeakSet = weakref.WeakSet()

    def paused_block(self) -> _Pause:
        return _Pause(self)

    def own(self, tensors) -> None:
        """Mark the storages of ``tensors`` (the arguments) as not the
        step's allocations."""
        for t in tensors:
            self._seen.add(t.untyped_storage())

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(isinstance(t, DTensor) for t in tree_flatten((args, kwargs))[0]):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            if name == "all_to_all_single" and sum(1 for n in args[1] if n) == 1:
                kind = "collective-permute"  # funcol.permute_tensor: one source a rank
            key = kind + "@0"
            self.collectives[key] = self.collectives.get(key, 0.0) + sum(
                _nbytes(t) for t in _tensors(out))
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags and ins:
            self.flops += ins[0].numel()
        if not outs or func.is_view or name in _NO_TRAFFIC:
            pass
        elif name in _FACTORIES:
            self.bytes += sum(_nbytes(t) for t in outs)
        elif name in _GATHERS:
            self.bytes += sum(_nbytes(t) for t in ins[1:] + outs)
        elif name in _SCATTERS:
            self.bytes += 2 * sum(_nbytes(t) for t in ins[1:])
        else:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        if not func.is_view:
            for t in outs:
                self._track(t)
        return out


@contextlib.contextmanager
def counted_alltoall(account: Account):
    """Count DTensor's all-to-all as one: while open, each call of torch's
    ``shard_dim_alltoall`` that ``account`` would see is counted as one
    ``all-to-all`` of its output (the local shard, the bytes a device
    receives), its input read and its output written, and the CPU
    fallback inside it (an all-gather of the whole, then a chunk) is not
    counted.  The original function is restored on exit."""
    from torch.distributed.tensor import _collective_utils, placement_types

    original = _collective_utils.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if account.paused:
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        with account.paused_block():
            out = original(input, gather_dim, shard_dim, mesh, mesh_dim)
        account.alltoall_fallbacks += 1
        key = "all-to-all@0"
        account.collectives[key] = account.collectives.get(key, 0.0) + _nbytes(out)
        account.bytes += _nbytes(input) + _nbytes(out)
        account._track(out)
        return out

    _collective_utils.shard_dim_alltoall = alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        _collective_utils.shard_dim_alltoall = original
        placement_types.shard_dim_alltoall = original


def collective_bytes(account: Account, depth: int) -> dict[str, float]:
    """The account's collective bytes keyed ``"<op>@<depth>"``: every
    collective of the trace sits at the loop depth ``depth`` (the loops the
    trace left out; see ``trip_schedule``)."""
    return {k.rsplit("@", 1)[0] + f"@{depth}": b for k, b in account.collectives.items()}


def weighted_collective_bytes(coll: dict[str, float], trips: list[float]) -> float:
    """Total collective bytes with per-loop-depth trip multipliers: an op at
    depth d executes prod(trips[:d]) times (deeper than the known schedule
    uses the full product)."""
    total = 0.0
    for key, b in coll.items():
        depth = int(key.rsplit("@", 1)[1])
        total += b * math.prod(trips[: min(depth, len(trips))])
    return total


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= max(d, 1)
    return tuple(reversed(stride))


def _placer(mesh):
    """``make(leaf, sharding)`` for :func:`shard.place`: a fake local shard
    of the abstract leaf, wrapped as a DTensor of the leaf's global shape."""

    def make(leaf: torch.Tensor, sharding: sh.NamedSharding) -> DTensor:
        shape = tuple(leaf.shape)
        local = torch.empty(sharding.shard_shape(shape), dtype=leaf.dtype)
        return DTensor.from_local(local, mesh, sharding.placements, run_check=False,
                                  shape=torch.Size(shape), stride=_contiguous_stride(shape))

    return make


def shard_bytes(tree, shardings) -> int:
    """The bytes one device holds of ``tree``'s tensors placed by
    ``shardings`` (a tree of :class:`~repro_torch.distributed.shard.NamedSharding`
    with ``tree``'s paths): each leaf's shard shape times its itemsize."""
    by_path = dict(sh.leaves_with_path(shardings))
    return sum(math.prod(by_path[path].shard_shape(tuple(t.shape))) * t.element_size()
               for path, t in sh.leaves_with_path(tree) if isinstance(t, torch.Tensor))


def run_cell(spec, cell, mesh, mesh_name: str) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.experimental import implicit_replication

    state = spec.abstract_state(cell)
    inputs = spec.abstract_inputs(cell)
    state_sh = spec.state_shardings(mesh, cell)
    input_sh = spec.input_shardings(mesh, cell)
    step = spec.step(cell)
    n_chips = mesh.size()
    arg_bytes = shard_bytes(state, state_sh) + shard_bytes(inputs, input_sh)

    account = Account()
    lock = ShardingPropagator._fake_mode_lock
    t0 = time.time()
    try:
        ShardingPropagator._fake_mode_lock = account.paused_block()
        with FakeTensorMode(allow_non_fake_inputs=True):
            make = _placer(mesh)
            state = sh.place(state, state_sh, make)
            inputs = sh.place(inputs, input_sh, make)
            t_place = time.time() - t0
            account.own(t.to_local() if isinstance(t, DTensor) else t
                        for _, t in sh.leaves_with_path({"s": state, "i": inputs})
                        if isinstance(t, torch.Tensor))
            with (logical_axis_rules(mesh), implicit_replication(), counted_alltoall(account),
                  account):
                out = step(state, inputs)
            args = {id(t) for _, t in sh.leaves_with_path({"s": state, "i": inputs})}
            out_bytes = sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
                            for _, t in sh.leaves_with_path(out)
                            if isinstance(t, torch.Tensor) and id(t) not in args)
    finally:
        ShardingPropagator._fake_mode_lock = lock
    t_trace = time.time() - t0 - t_place

    trip = float(spec.hlo_trip_factor(cell))
    trips = spec.trip_schedule(cell)
    coll = collective_bytes(account, len(trips))
    flops = account.flops * trip
    bytes_acc = account.bytes * trip
    coll_total = weighted_collective_bytes(coll, trips)
    per_chip = dict(flops=flops, bytes=bytes_acc, coll_bytes=coll_total)
    terms = dict(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_acc / HBM_BW,
        collective_s=coll_total / LINK_BW,
    )
    dominant = max(terms, key=terms.get)
    model_flops = spec.model_flops(cell)
    temp = int(account.peak)
    return dict(
        arch=spec.id,
        cell=cell.name,
        mesh=mesh_name,
        n_chips=int(n_chips),
        ok=True,
        t_lower_s=round(t_place, 2),
        t_compile_s=round(t_trace, 2),
        bytes_per_device=int(arg_bytes) + temp,
        temp_bytes=temp,
        arg_bytes=int(arg_bytes),
        out_bytes=int(out_bytes),
        hlo_flops=flops,
        hlo_bytes=bytes_acc,
        collective_bytes=coll_total,
        collectives=coll,
        alltoall_fallbacks=account.alltoall_fallbacks,
        trip_factor=trip,
        per_chip=per_chip,
        roofline=terms,
        dominant=dominant,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / (flops * n_chips)) if flops else None,
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--cell", default=None, help="single cell name")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    arch_ids = [args.arch] if args.arch else configs.ARCH_IDS
    meshes = {
        "pod": (lambda: mesh_mod.make_production_mesh(multi_pod=False)),
        "multipod": (lambda: mesh_mod.make_production_mesh(multi_pod=True)),
    }
    if args.mesh != "both":
        meshes = {args.mesh: meshes[args.mesh]}

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    logging.getLogger("torch._logging").setLevel(logging.ERROR)
    failures = 0
    t_all = time.time()
    try:
        for arch_id in arch_ids:
            spec = configs.get(arch_id)
            for cell_name, cell in spec.cells().items():
                if args.cell and cell_name != args.cell:
                    continue
                reason = spec.skip_reason(cell_name)
                for mesh_name, mk in meshes.items():
                    fn = os.path.join(args.out, f"{arch_id}__{cell_name}__{mesh_name}.json")
                    if os.path.exists(fn) and not args.force:
                        print(f"[skip-cached] {arch_id} {cell_name} {mesh_name}")
                        continue
                    if reason is not None:
                        rec = dict(arch=arch_id, cell=cell_name, mesh=mesh_name,
                                   ok=True, skipped=reason)
                        with open(fn, "w") as f:
                            json.dump(rec, f, indent=1)
                        print(f"[skip] {arch_id} {cell_name}: {reason}")
                        continue
                    print(f"[run ] {arch_id} {cell_name} {mesh_name} ...", flush=True)
                    try:
                        rec = run_cell(spec, cell, mk(), mesh_name)
                        print(
                            f"       ok: {rec['bytes_per_device'] / 2**30:.2f} GiB/dev, "
                            f"compute {rec['roofline']['compute_s']:.3e}s "
                            f"memory {rec['roofline']['memory_s']:.3e}s "
                            f"coll {rec['roofline']['collective_s']:.3e}s "
                            f"-> {rec['dominant']} ({rec['t_compile_s']} s)",
                            flush=True,
                        )
                    except Exception as e:  # noqa: BLE001
                        failures += 1
                        rec = dict(arch=arch_id, cell=cell_name, mesh=mesh_name,
                                   ok=False, error=repr(e),
                                   traceback=traceback.format_exc()[-4000:])
                        print(f"       FAIL: {e!r}", flush=True)
                    with open(fn, "w") as f:
                        json.dump(rec, f, indent=1)
    finally:
        mesh_mod.release()
    print(f"done; failures={failures}; {time.time() - t_all:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
