"""The port's sharding rules, logical-axis context and sharded restore
against the JAX package.

The reference's shard shapes come from a subprocess per production mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=512``: this process's
JAX is already initialised with one device): for every architecture, every
cell it does not skip, and every state and input leaf,
``NamedSharding(mesh, safe_spec(...)).shard_shape(shape)``.  The port's
side places the same leaves by its own ``state_shardings`` /
``input_shardings`` on the 16x16 and 2x16x16 meshes of the fake process
group and reads each leaf's local shard shape from DTensor.  The port keeps
an LM's layers apart where the reference stacks them, so a reference leaf
``[L, ...]`` is held against each of the port's L per-layer leaves.
Every fixture that makes a process group destroys it.
"""
import concurrent.futures as cf
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as ref_configs
from repro.distributed import ctx as ref_ctx
from repro.distributed import shard as ref_sh
from repro.models import transformer as ref_tr
from repro_torch import configs, convert
from repro_torch.checkpoint import ckpt
from repro_torch.distributed import ctx
from repro_torch.distributed import shard as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as tr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}

_REF_SCRIPT = r"""
import json, sys
import jax
from jax.sharding import NamedSharding
from repro import configs
from repro.launch.mesh import make_production_mesh

def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)

mesh = make_production_mesh(multi_pod=sys.argv[1] == "multipod")
out = {}
for arch in configs.ARCH_IDS:
    spec = configs.get(arch)
    for cname, cell in spec.cells().items():
        if spec.skip_reason(cname) is not None:
            continue
        rec = {}
        for kind, tree, shs in (
                ("state", spec.abstract_state(cell), spec.state_shardings(mesh, cell)),
                ("inputs", spec.abstract_inputs(cell), spec.input_shardings(mesh, cell))):
            leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
            sl = jax.tree_util.tree_leaves(shs, is_leaf=lambda x: isinstance(x, NamedSharding))
            assert len(leaves) == len(sl), (arch, cname, kind)
            rec[kind] = {path_str(p): [list(l.shape), list(s.shard_shape(l.shape)), str(l.dtype)]
                         for (p, l), s in zip(leaves, sl)}
        out[arch + "|" + cname] = rec
print(json.dumps(out))
"""


def _reference(mesh_name: str) -> dict:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT, mesh_name], env=env,
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return json.loads(out.stdout.splitlines()[-1])


def _cells():
    return [(a, c) for a in configs.ARCH_IDS for c in configs.get(a).cells()
            if configs.get(a).skip_reason(c) is None]


def _port_side(mesh) -> dict:
    """(arch, cell) -> {"state"|"inputs": {path: (shape, local shape,
    dtype, shard_shape)}, "names": the params' names} on ``mesh``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    out = {}
    for arch, cname in _cells():
        spec = configs.get(arch)
        cell = spec.cells()[cname]
        rec = {}
        for kind, tree, shs in (
                ("state", spec.abstract_state(cell), spec.state_shardings(mesh, cell)),
                ("inputs", spec.abstract_inputs(cell), spec.input_shardings(mesh, cell))):
            by_path = dict(sh.leaves_with_path(shs))
            leaves = dict(sh.leaves_with_path(tree))
            assert set(by_path) == set(leaves), (arch, cname, kind)
            rec[kind] = {}
            for path, leaf in leaves.items():
                ns = by_path[path]
                shape = tuple(leaf.shape)
                local, _ = compute_local_shape_and_global_offset(shape, mesh, ns.placements)
                rec[kind][path] = (shape, tuple(local), str(leaf.dtype).replace("torch.", ""),
                                   ns.shard_shape(shape))
        state = spec.abstract_state(cell)
        params = state["params"] if isinstance(state, dict) else None
        rec["names"] = [n for n, _ in params.named_parameters()] if params is not None else []
        rec["family"] = spec.family
        out[(arch, cname)] = rec
    return out


@pytest.fixture(scope="module")
def shard_shapes():
    """Both packages' shard shapes on both production meshes."""
    with cf.ThreadPoolExecutor(2) as ex:
        refs = {m: ex.submit(_reference, m) for m in MESHES}
        port = {}
        try:
            for m in MESHES:
                port[m] = _port_side(mesh_mod.make_production_mesh(multi_pod=m == "multipod"))
        finally:
            mesh_mod.release()
        return {m: (refs[m].result(), port[m]) for m in MESHES}


def _ref_path(path: str, names: list[str], lm: bool) -> tuple[str, int | None]:
    """The reference's path for a port leaf path, and the layer index the
    port's per-layer leaf holds (None if the leaf is not stacked)."""
    parts = path.split("/")
    if parts[0] == "opt" and parts[1] in ("mu", "nu"):
        parts = parts[:2] + names[int(parts[2])].split(".")
    elif parts[0] == "params":
        parts = parts[:1] + parts[1].split(".")
    layer = None
    if lm and "layers" in parts:
        i = parts.index("layers")
        layer = int(parts.pop(i + 1))
    return "/".join(parts), layer


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,cell", _cells())
def test_shard_shapes_match_reference(shard_shapes, mesh_name, arch, cell):
    ref_all, port_all = shard_shapes[mesh_name]
    ref, port = ref_all[f"{arch}|{cell}"], port_all[(arch, cell)]
    lm = port["family"] == "lm"
    for kind in ("state", "inputs"):
        seen = set()
        for path, (shape, local, dtype, shard_shape) in port[kind].items():
            assert local == shard_shape, (kind, path)
            rpath, layer = _ref_path(path, port["names"], lm)
            assert rpath in ref[kind], (kind, path, rpath)
            r_shape, r_shard, r_dtype = ref[kind][rpath]
            seen.add(rpath)
            assert dtype == r_dtype, (kind, path)
            if layer is None:
                assert list(shape) == r_shape and list(local) == r_shard, (kind, path)
            else:  # one layer of the reference's stacked [L, ...] leaf
                assert layer < r_shape[0] and r_shard[0] == r_shape[0], (kind, path)
                assert list(shape) == r_shape[1:] and list(local) == r_shard[1:], (kind, path)
        assert seen == set(ref[kind]), kind


# --------------------------------------------------------------------- #
# rules, safe_spec, batch_spec, placements
# --------------------------------------------------------------------- #
class _RefMesh:
    """What the reference's helpers read of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _jp(spec: sh.P) -> JP:
    return JP(*spec)


def _norm(spec) -> tuple:
    """A spec's entries with one-axis tuples as the bare name (JAX's
    PartitionSpec stores ``("data",)`` as ``"data"``)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)


SPECS = [sh.P(None), sh.P("data"), sh.P("model", "data"), sh.P(("data", "model"), None),
         sh.P(("pod", "data", "model")), sh.P(None, ("pod", "data")), sh.P("pod", None, "model")]
SHAPES = [(0,), (1,), (8,), (16, 3), (48, 32), (256, 7), (512, 4096), (33_762_577, 16),
          (96, 2, 16), (7, 256, 512)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_safe_spec_and_batch_spec_match_reference(mesh_name):
    shape_map = MESHES[mesh_name]
    ref_mesh = _RefMesh(shape_map)
    for spec in SPECS:
        if any(a not in shape_map for axes in spec if axes
               for a in ((axes,) if isinstance(axes, str) else axes)):
            continue
        for shape in SHAPES:
            want = ref_sh.safe_spec(shape, _jp(spec), ref_mesh)
            got = sh.safe_spec(shape, spec, shape_map)
            assert _norm(got) == _norm(want), (spec, shape)
    for b in (1, 2, 8, 16, 32, 100, 128, 256, 512, 65536):
        assert _norm(sh.batch_spec(shape_map, b)) == _norm(ref_sh.batch_spec(ref_mesh, b)), b
    assert sh.data_axes(shape_map) == ref_sh.data_axes(ref_mesh)
    assert sh.all_axes(shape_map) == ref_sh.all_axes(ref_mesh)


def test_rule_tables_match_reference():
    """Same specs, rule for rule; the port's LM rules match per-layer names
    (``attn.wq``) and drop the reference's leading layer ``None``."""
    for arch in ("internlm2-1.8b", "olmoe-1b-7b", "mixtral-8x7b"):
        for mesh_name, shape_map in MESHES.items():
            ref_rules = ref_sh.lm_param_rules(ref_configs.get(arch).cfg, _RefMesh(shape_map))
            rules = sh.lm_param_rules(configs.get(arch).cfg, shape_map)
            assert len(rules) == len(ref_rules)
            for (pat, spec), (rpat, rspec) in zip(rules, ref_rules):
                assert pat.replace(r"\.", "/") == rpat
                layered = rpat.startswith(("attn", "mlp", "moe")) or "attn" in rpat
                want = tuple(rspec)[1:] if layered and len(rspec) > 1 else tuple(rspec)
                assert _norm(spec) == _norm(want), pat
    ref_rec = ref_sh.recsys_param_rules(None)
    for (pat, spec), (rpat, rspec) in zip(sh.recsys_param_rules(None), ref_rec):
        assert pat.replace(r"\.", "/") == rpat and _norm(spec) == _norm(rspec)
    assert [_norm(s) for _, s in sh.gnn_param_rules(None)] == [
        _norm(s) for _, s in ref_sh.gnn_param_rules(None)]
    for shape_map in MESHES.values():
        ref_mesh = _RefMesh(shape_map)
        for fn in ("gnn_input_specs", "dualsim_sparse_specs", "dualsim_dense_specs"):
            got, want = getattr(sh, fn)(shape_map), getattr(ref_sh, fn)(ref_mesh)
            assert {k: _norm(v) for k, v in got.items()} == {
                k: _norm(v) for k, v in want.items()}, fn
        for b in (1, 128, 65536):
            got = sh.recsys_input_specs(shape_map, b)
            want = ref_sh.recsys_input_specs(ref_mesh, b)
            assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in want.items()}
            got = sh.lm_input_specs(shape_map, b)
            want = ref_sh.lm_input_specs(ref_mesh, b)
            assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in want.items()}
            cfg = configs.get("qwen3-8b").cfg
            got = sh.lm_cache_spec(shape_map, cfg, b, 32768)
            want = ref_sh.lm_cache_spec(ref_mesh, ref_configs.get("qwen3-8b").cfg, b, 32768)
            assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in want.items()}


@pytest.fixture
def fake_mesh():
    """A 2x4 (data, model) mesh of the fake process group, destroyed after."""
    try:
        yield mesh_mod.make_fake_mesh((2, 4), ("data", "model"))
    finally:
        mesh_mod.release()


def test_to_placements(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard

    assert sh.to_placements(sh.P(), fake_mesh) == (Replicate(), Replicate())
    assert sh.to_placements(sh.P(None, "model"), fake_mesh) == (Replicate(), Shard(1))
    assert sh.to_placements(sh.P("model", "data"), fake_mesh) == (Shard(1), Shard(0))
    assert sh.to_placements(sh.P(("data", "model"), None), fake_mesh) == (Shard(0), Shard(0))
    with pytest.raises(NotImplementedError):
        sh.to_placements(sh.P(("model", "data")), fake_mesh)
    assert _norm(sh.named(fake_mesh, (6, 8), sh.P(("data", "model"), "model")).spec) == (
        "data", "model")
    assert sh.named(fake_mesh, (16, 8), sh.P(("data", "model"), None)).shard_shape((16, 8)) == (
        2, 8)


# --------------------------------------------------------------------- #
# the logical-axis context
# --------------------------------------------------------------------- #
LOGICAL = [("batch", None, "heads", None), ("batch", None, None), ("batch", None, "vocab"),
           ("batch", "expert", None, None), ("nodes", None), ("edges", None, None),
           ("moe_tokens",), ("kv_seq", "embed_fsdp")]
LSHAPES = [(8, 4, 16, 3), (6, 5, 7), (4, 3, 96), (2, 8, 3, 5), (32, 7), (64, 2, 3), (24,),
           (16, 12)]


@pytest.mark.parametrize("mesh_name", ["small", "small3", *MESHES])
def test_group_count_and_spec_match_reference(mesh_name, monkeypatch):
    shape_map = {"small": {"data": 2, "model": 4}, "small3": {"pod": 2, "data": 2, "model": 2},
                 **MESHES}[mesh_name]
    captured = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: captured.append(spec) or x)
    assert ctx.group_count("batch", 64) == 1 and ctx.logical_spec((4,), "batch") is None
    x = torch.zeros(4)
    assert ctx.constrain(x, "batch") is x
    with ref_ctx.logical_axis_rules(_RefMesh(shape_map)), ctx.logical_axis_rules(shape_map):
        for name in ctx.DEFAULT_RULES:
            for dim in (1, 2, 3, 8, 12, 16, 64, 96, 256, 512, 4096):
                assert ctx.group_count(name, dim) == ref_ctx.group_count(name, dim)
        for logical, shape in zip(LOGICAL, LSHAPES):
            for scale in (1, 16, 32):
                shp = tuple(d * scale for d in shape)
                ref_ctx.constrain(jnp.zeros(shp, jnp.int8), *logical)
                got = ctx.logical_spec(shp, *logical)
                assert _norm(got) == _norm(captured[-1]), (logical, shp)
                plain = torch.zeros(shp, dtype=torch.int8)
                assert ctx.constrain(plain, *logical) is plain
    assert ctx.group_count("batch", 64) == 1


def test_constrain_redistributes_a_dtensor(fake_mesh, monkeypatch):
    from torch.distributed.tensor import DTensor, Replicate

    captured = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: captured.append(spec) or x)
    shape_map = {"data": 2, "model": 4}
    x = DTensor.from_local(torch.zeros(8, 4, 16, 3), fake_mesh, [Replicate(), Replicate()],
                           run_check=False)
    with ref_ctx.logical_axis_rules(_RefMesh(shape_map)), ctx.logical_axis_rules(fake_mesh):
        for logical in (("batch", None, "heads", None), ("batch", None, None, None),
                        (None, None, "vocab", None)):
            ref_ctx.constrain(jnp.zeros((8, 4, 16, 3)), *logical)
            y = ctx.constrain(x, *logical)
            assert isinstance(y, DTensor)
            assert tuple(y.placements) == sh.to_placements(sh.P(*captured[-1]), fake_mesh)
            assert tuple(y.to_local().shape) == sh.NamedSharding(
                fake_mesh, sh.P(*captured[-1])).shard_shape((8, 4, 16, 3))
    assert ctx.constrain(x, "batch", None, "heads", None) is x


def _ref_dispatch(ref_cfg, router, xg):
    """The JAX package's ``moe_block`` dispatch with its own ``jnp`` calls
    (as ``tests/test_torch_moe.py`` recomputes it)."""
    import math

    m = ref_cfg.moe
    g_, tl, _ = xg.shape
    k, e = m.top_k, m.n_experts
    tkl = tl * k
    probs = jax.nn.softmax((xg @ router.astype(jnp.float32)).astype(jnp.float32), -1)
    _, topi = jax.lax.top_k(probs, k)
    e_flat = topi.reshape(g_, tkl)
    tok_flat = jnp.broadcast_to(jnp.arange(tkl, dtype=jnp.int32) // k, (g_, tkl))
    order = jnp.argsort(e_flat, axis=-1, stable=True)
    e_s = jnp.take_along_axis(e_flat, order, -1)
    tok_s = jnp.take_along_axis(tok_flat, order, -1)
    counts = jax.vmap(lambda es: jnp.bincount(es, length=e))(e_s)
    starts = jnp.cumsum(counts, axis=-1) - counts
    pos = jnp.arange(tkl, dtype=jnp.int32)[None] - jnp.take_along_axis(starts, e_s, -1)
    cap = max(int(math.ceil(tl * k / e * m.capacity_factor)), k)
    return [np.asarray(a) for a in (e_s, tok_s, pos, counts)] + [cap]


@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_dispatch_in_groups_under_rules_matches_reference(arch, data, monkeypatch):
    """Under rules the MoE block blocks its tokens into ``group_count``
    groups: G = data > 1, the dispatch equal exactly, the output within
    the LM tolerances."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: x)
    ref_spec, spec = ref_configs.get(arch), configs.get(arch)
    ref_cfg, cfg = ref_spec.reduced(), spec.reduced()
    ref_p = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg, device="cpu")
    ref_moe = jax.tree.map(lambda a: a[0], ref_p["layers"]["moe"])
    moe = model.layers[0].moe
    x = np.random.default_rng(3).normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    shape_map = {"data": data, "model": 2}
    with ref_ctx.logical_axis_rules(_RefMesh(shape_map)), ctx.logical_axis_rules(shape_map):
        g_ = ctx.group_count("batch", 64)
        assert g_ == ref_ctx.group_count("batch", 64) == data
        # traced under the rules: the groups are fixed at trace time
        want, want_aux = jax.jit(lambda p, v: ref_tr.moe_block(ref_cfg, p, v))(
            ref_moe, jnp.asarray(x))
        with torch.no_grad():
            got, aux = tr.moe_block(cfg, moe, torch.from_numpy(x))
    xg = x.reshape(g_, -1, cfg.d_model)
    e_s, tok_s, pos, counts, cap = _ref_dispatch(ref_cfg, ref_moe["router"], jnp.asarray(xg))
    with torch.no_grad():
        _, disp = tr.route(cfg, moe.router, torch.from_numpy(xg))
    assert disp.cap == cap
    for a, b in ((disp.expert, e_s), (disp.token, tok_s), (disp.pos, pos),
                 (disp.counts, counts)):
        np.testing.assert_array_equal(a.numpy(), b)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


# --------------------------------------------------------------------- #
# ckpt.restore(shardings=)
# --------------------------------------------------------------------- #
def _small_state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"table": torch.randn(16, 4, generator=g),
                       "w": torch.randn(4, 8, generator=g)},
            "opt": {"mu": [torch.randn(16, 4, generator=g), torch.randn(4, 8, generator=g)],
                    "step": torch.tensor(3, dtype=torch.int32)}}


def _shardings(mesh):
    return {"params": {"table": sh.named(mesh, (16, 4), sh.P(("data", "model"), None)),
                       "w": sh.named(mesh, (4, 8), sh.P(None, "model"))},
            "opt": {"mu": [sh.named(mesh, (16, 4), sh.P(("data", "model"), None)),
                           sh.named(mesh, (4, 8), sh.P(None, "model"))],
                    "step": sh.NamedSharding(mesh, sh.P())}}


@pytest.mark.parametrize("where", ["host", "fake2x4"])
def test_restore_with_shardings_places_dtensors(where, tmp_path):
    from torch.distributed.tensor import DTensor

    state = _small_state()
    ckpt.save(str(tmp_path), 3, state)
    try:
        mesh = (mesh_mod.make_host_mesh("cpu") if where == "host"
                else mesh_mod.make_fake_mesh((2, 4), ("data", "model")))
        shardings = _shardings(mesh)
        got, step = ckpt.restore(str(tmp_path), state, shardings=shardings)
        assert step == 3
        want = dict(sh.leaves_with_path(state))
        by_path = dict(sh.leaves_with_path(shardings))
        for path, leaf in sh.leaves_with_path(got):
            assert isinstance(leaf, DTensor), path
            ns = by_path[path]
            assert tuple(leaf.placements) == ns.placements, path
            assert tuple(leaf.to_local().shape) == ns.shard_shape(tuple(want[path].shape))
            # rank 0's shard: the leading block of every sharded dim
            idx = tuple(slice(0, n) for n in leaf.to_local().shape)
            torch.testing.assert_close(leaf.to_local(), want[path][idx], rtol=0, atol=0)
        if where == "host":  # a whole value round-trips through save
            ckpt.save(str(tmp_path / "again"), 4, got)
            back, _ = ckpt.restore(str(tmp_path / "again"), state)
            for (p, a), (_, b) in zip(sh.leaves_with_path(back), sh.leaves_with_path(state)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    finally:
        mesh_mod.release()


def test_meshes_and_release():
    try:
        pod = mesh_mod.make_production_mesh()
        assert pod.mesh_dim_names == ("data", "model") and tuple(pod.mesh.shape) == (16, 16)
        multi = mesh_mod.make_production_mesh(multi_pod=True)
        assert multi.mesh_dim_names == ("pod", "data", "model")
        assert tuple(multi.mesh.shape) == (2, 16, 16)
        host = mesh_mod.make_host_mesh("cpu")
        assert tuple(host.mesh.shape) == (1, 1) and host.device_type == "cpu"
    finally:
        mesh_mod.release()
    assert not torch.distributed.is_initialized()
