"""The port's ArchSpec hooks and production dry-run against the JAX package.

For every architecture and cell: the useful-FLOP count equals the
reference's exactly, and the abstract state and inputs (meta tensors, or fake CPU
tensors for the CPU-only edge lists, in the port; ``ShapeDtypeStruct`` in the
reference) have the same shapes and
dtypes, an LM's per-layer leaves stacked giving the reference's ``[L, ...]``
leaf.  ``run_cell`` traces each family's ``reduced()`` config over a 2x2
mesh of the fake process group, and ``dcn-v2`` and both dual-simulation
workloads at the 16x16 production mesh, each giving an ``ok`` record with
the reference's keys and ``alltoall_fallbacks``.  Every fixture that makes a process group destroys it.
"""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

# the keys of the reference's dry-run record (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "cell", "mesh", "n_chips", "ok", "t_lower_s", "t_compile_s",
            "bytes_per_device", "temp_bytes", "arg_bytes", "out_bytes", "hlo_flops",
            "hlo_bytes", "collective_bytes", "collectives", "trip_factor", "per_chip",
            "roofline", "dominant", "model_flops", "useful_flops_ratio"}
# the port's one key more: how often torch's CPU all-to-all fallback ran
PORT_KEYS = REF_KEYS | {"alltoall_fallbacks"}
ALL_CELLS = [(a, c) for a in configs.ARCH_IDS for c in configs.get(a).cells()]


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch,cell", ALL_CELLS)
def test_model_flops_and_cells_match_reference(arch, cell):
    spec, ref_spec = configs.get(arch), ref_configs.get(arch)
    assert spec.id == ref_spec.id == arch and spec.family == ref_spec.family
    assert list(spec.cells()) == list(ref_spec.cells())
    c, rc = spec.cells()[cell], ref_spec.cells()[cell]
    assert dataclasses.astuple(c) == dataclasses.astuple(rc)
    assert spec.model_flops(c) == ref_spec.model_flops(rc)
    assert spec.skip_reason(cell) == ref_spec.skip_reason(cell)
    assert spec.hlo_trip_factor(c) == float(np.prod(spec.trip_schedule(c)))
    if spec.family == "dualsim":  # the one loop the port's trace leaves out
        assert spec.hlo_trip_factor(c) == ref_spec.hlo_trip_factor(rc)
    else:
        assert spec.hlo_trip_factor(c) == 1.0 and spec.trip_schedule(c) == []


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch, cell):
    spec = ref_configs.get(arch)
    c = spec.cells()[cell]
    flat = lambda t: {  # noqa: E731
        "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in p):
        (tuple(leaf.shape), str(leaf.dtype))
        for p, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    return flat(spec.abstract_state(c)), flat(spec.abstract_inputs(c))


@pytest.mark.parametrize("arch,cell", ALL_CELLS)
def test_abstract_state_and_inputs_match_reference(arch, cell):
    from repro_torch.distributed import shard as sh

    spec = configs.get(arch)
    c = spec.cells()[cell]
    ref_state, ref_inputs = _ref_abstract(arch, cell)
    state, inputs = spec.abstract_state(c), spec.abstract_inputs(c)
    got_in = {p: (tuple(t.shape), _dtype(t)) for p, t in sh.leaves_with_path(inputs)}
    assert got_in == ref_inputs
    leaves = sh.leaves_with_path(state)
    from torch._subclasses.fake_tensor import FakeTensor

    # no storage: meta tensors, or fake CPU tensors for the CPU-only edge lists
    assert all(t.device.type == "meta" or isinstance(t, FakeTensor) for _, t in leaves)
    names = ([n for n, _ in state["params"].named_parameters()]
             if isinstance(state, dict) else [])
    got: dict = {}
    for path, t in leaves:
        parts = path.split("/")
        if parts[0] == "opt" and parts[1] in ("mu", "nu"):
            parts = parts[:2] + names[int(parts[2])].split(".")
        elif parts[0] == "params":
            parts = parts[:1] + parts[1].split(".")
        if spec.family == "lm" and "layers" in parts:  # stack the layers
            i = parts.index("layers")
            layer = int(parts.pop(i + 1))
            key = "/".join(parts)
            got.setdefault(key, {})[layer] = (tuple(t.shape), _dtype(t))
        else:
            got["/".join(parts)] = (tuple(t.shape), _dtype(t))
    for key, v in list(got.items()):
        if isinstance(v, dict):
            assert sorted(v) == list(range(len(v))), key
            shapes = set(v.values())
            assert len(shapes) == 1, key
            (shape, dt), = shapes
            got[key] = ((len(v), *shape), dt)
    assert got == ref_state


# --------------------------------------------------------------------- #
# run_cell
# --------------------------------------------------------------------- #
@pytest.fixture
def mesh2x2():
    try:
        yield mesh_mod.make_fake_mesh((2, 2), ("data", "model"))
    finally:
        mesh_mod.release()


@pytest.fixture
def pod():
    try:
        yield mesh_mod.make_production_mesh()
    finally:
        mesh_mod.release()


def _check(rec, spec, cell, n_chips):
    assert set(rec) == PORT_KEYS
    assert rec["ok"] and rec["arch"] == spec.id and rec["cell"] == cell.name
    assert rec["n_chips"] == n_chips
    assert rec["model_flops"] == spec.model_flops(cell)
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["bytes_per_device"] == rec["arg_bytes"] + rec["temp_bytes"] > 0
    assert rec["dominant"] in rec["roofline"]
    assert rec["trip_factor"] == spec.hlo_trip_factor(cell)
    assert rec["collective_bytes"] == pytest.approx(dryrun.weighted_collective_bytes(
        rec["collectives"], spec.trip_schedule(cell)))
    json.dumps(rec)


SMALL = {
    "lm-train": base.Cell("t", "train", batch=4, seq=32, microbatches=2),
    "lm-prefill": base.Cell("p", "prefill", batch=4, seq=32),
    "lm-decode": base.Cell("d", "decode", batch=4, seq=32),
    "rec-train": base.Cell("t", "train", batch=64, microbatches=2),
    "rec-serve": base.Cell("s", "serve", batch=64),
    "rec-retrieval": base.Cell("r", "retrieval", batch=1, extras=dict(n_candidates=256)),
}


def _reduced_spec(arch):
    spec = configs.get(arch)
    if spec.family == "gnn":
        return base.GNNArch(arch, spec.reduced())
    return type(spec)(spec.reduced())


@pytest.mark.parametrize("arch,kind", [
    ("internlm2-1.8b", "lm-train"), ("qwen3-8b", "lm-prefill"), ("yi-6b", "lm-decode"),
    ("olmoe-1b-7b", "lm-train"), ("mixtral-8x7b", "lm-train"), ("mixtral-8x7b", "lm-decode"),
    ("dcn-v2", "rec-train"), ("dcn-v2", "rec-serve"), ("dcn-v2", "rec-retrieval"),
])
def test_run_cell_reduced(mesh2x2, arch, kind):
    spec = _reduced_spec(arch)
    cell = SMALL[kind]
    _check(dryrun.run_cell(spec, cell, mesh2x2, "2x2"), spec, cell, 4)


@pytest.mark.parametrize("arch", ["gatedgcn", "gat-cora", "pna", "schnet"])
@pytest.mark.parametrize("cell_name", ["full_graph_sm", "molecule"])
def test_run_cell_reduced_gnn(mesh2x2, arch, cell_name):
    spec = _reduced_spec(arch)
    cell = spec.cells()[cell_name]
    _check(dryrun.run_cell(spec, cell, mesh2x2, "2x2"), spec, cell, 4)


@pytest.mark.parametrize("arch,cell_name", [
    ("dcn-v2", c) for c in configs.get("dcn-v2").cells()] + [
    (a, c) for a in ("dualsim-lubm", "dualsim-dbpedia") for c in configs.get(a).cells()])
def test_run_cell_at_the_pod_mesh(pod, arch, cell_name):
    spec = configs.get(arch)
    cell = spec.cells()[cell_name]
    rec = dryrun.run_cell(spec, cell, pod, "pod")
    _check(rec, spec, cell, 256)
    if spec.family == "dualsim":  # one traced sweep stands for the fixpoint's
        assert rec["hlo_flops"] == pytest.approx(
            spec.hlo_trip_factor(cell) * rec["per_chip"]["flops"] / rec["trip_factor"])
        assert all(k.endswith("@1") for k in rec["collectives"])
    if arch == "dcn-v2":
        assert rec["arg_bytes"] >= spec.cfg.total_vocab * spec.cfg.embed_dim * 4


def test_weighted_collective_bytes():
    coll = {"all-gather@0": 10.0, "all-reduce@1": 3.0, "reduce-scatter@2": 1.0}
    assert dryrun.weighted_collective_bytes(coll, []) == 14.0
    assert dryrun.weighted_collective_bytes(coll, [5.0]) == 10.0 + 15.0 + 5.0
    assert dryrun.weighted_collective_bytes(coll, [2.0, 3.0]) == 10.0 + 6.0 + 6.0


def test_main_writes_records_and_skips(tmp_path):
    """The CLI on one arch: a record per cell and mesh, the full-attention
    ``long_500k`` cell recorded as skipped with the reference's reason."""
    rc = dryrun.main(["--arch", "internlm2-1.8b", "--cell", "long_500k", "--mesh", "both",
                      "--out", str(tmp_path)])
    assert rc == 0
    ref_reason = ref_configs.get("internlm2-1.8b").skip_reason("long_500k")
    for m in ("pod", "multipod"):
        rec = json.loads((tmp_path / f"internlm2-1.8b__long_500k__{m}.json").read_text())
        assert rec == dict(arch="internlm2-1.8b", cell="long_500k", mesh=m, ok=True,
                           skipped=ref_reason)
    rc = dryrun.main(["--arch", "dcn-v2", "--cell", "serve_p99", "--mesh", "pod",
                      "--out", str(tmp_path)])
    assert rc == 0 and not torch.distributed.is_initialized()
    rec = json.loads((tmp_path / "dcn-v2__serve_p99__pod.json").read_text())
    assert set(rec) == PORT_KEYS and rec["ok"]
