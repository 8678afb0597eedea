"""The port's production dry-run beside the JAX package's, cell for cell.

The reference's records come from one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=512``: this process's
JAX is already initialised with one device) that runs
``repro.launch.dryrun.run_cell`` on the (arch, cell) pairs below over the
16x16 ``pod`` mesh: ``dualsim-lubm``'s ``batch16_sparse``, ``q_sparse``
and ``q_partitioned``, and the LM serving cells (internlm2, olmoe and
mixtral ``decode_32k``, olmoe ``prefill_32k``, mixtral ``long_500k``);
the port's come from ``repro_torch.launch.dryrun.run_cell`` in this
process, over the fake process group.  Bytes and FLOPs are compared, not
times (the two use different hardware constants).  What is held:

* argument bytes within 1 KiB (the gap is ``var_copy``, which no sweep of
  these cells reads and XLA leaves out of its arguments), and
  ``model_flops`` equal;
* ``batch16_sparse``: the port's bytes a device at most 1.25x the
  reference's, and below 80 GB;
* the collective bytes of each lubm cell, every kind summed, at most 1.5x
  the reference's;
* the LM serving cells, whose KV cache stays in ``lm_cache_spec``'s
  placement: ``out_bytes`` at most the reference's; the collective bytes
  a step (the reference's per-layer loop weighted by its trips, the
  port's trace unrolled) at most 1.5x the reference's; bytes a device at
  most the reference's for internlm2's and olmoe's ``decode_32k``, at
  most 1.5x for mixtral's (whose expert weights are gathered in bf16),
  and at most 1.25x for mixtral's ``long_500k``.

Also: on the fake 16x16 mesh, a ``Shard(0)`` to ``Shard(1)`` redistribute
(DTensor's all-to-all, which it runs on a CPU mesh as an all-gather of the
whole and a chunk) is counted as one all-to-all of the local shard's bytes
and no all-gather, and ``run_cell``'s record says how often that ran; and
``funcol.permute_tensor`` is counted as a collective-permute of the one
message a rank receives.  Every fixture that makes a process group
destroys it.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "dualsim-lubm"
CELLS = ("batch16_sparse", "q_sparse", "q_partitioned")
# (arch, cell) -> the bound on the port's bytes a device, over the reference's
SERVE_CELLS = {
    ("internlm2-1.8b", "decode_32k"): 1.0,
    ("olmoe-1b-7b", "decode_32k"): 1.0,
    ("mixtral-8x7b", "decode_32k"): 1.5,
    ("olmoe-1b-7b", "prefill_32k"): None,
    ("mixtral-8x7b", "long_500k"): 1.25,
}
PAIRS = tuple((ARCH, c) for c in CELLS) + tuple(SERVE_CELLS)
GB = 1e9

_REF_SCRIPT = """
import json, sys
from repro.launch import dryrun  # sets the 512-device XLA flag before JAX starts
from repro import configs
from repro.launch.mesh import make_production_mesh

mesh = make_production_mesh(multi_pod=False)
out = {}
for pair in sys.argv[1:]:
    arch, cell = pair.split(":")
    spec = configs.get(arch)
    out[pair] = dryrun.run_cell(spec, spec.cells()[cell], mesh, "pod")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    """{(arch, cell): (the reference's record, the port's record)} on
    ``pod``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, *(f"{a}:{c}" for a, c in PAIRS)],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           cwd=ROOT)
    port = {}
    try:
        for arch, cell in PAIRS:
            spec = configs.get(arch)
            port[arch, cell] = dryrun.run_cell(spec, spec.cells()[cell],
                                               mesh_mod.make_production_mesh(), "pod")
    finally:
        mesh_mod.release()
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    ref_recs = json.loads(out.splitlines()[-1])
    return {(a, c): (ref_recs[f"{a}:{c}"], port[a, c]) for a, c in PAIRS}


@pytest.mark.parametrize("cell", CELLS)
def test_arguments_and_model_flops_equal_the_reference(records, cell):
    ref, port = records[ARCH, cell]
    assert ref["ok"] and port["ok"]
    assert abs(port["arg_bytes"] - ref["arg_bytes"]) <= 1024
    assert port["model_flops"] == ref["model_flops"]


def test_batch16_sparse_fits_like_the_reference(records):
    ref, port = records[ARCH, "batch16_sparse"]
    assert port["bytes_per_device"] <= 1.25 * ref["bytes_per_device"]
    assert port["bytes_per_device"] < 80 * GB


@pytest.mark.parametrize("cell", CELLS)
def test_collective_bytes_within_the_reference_bound(records, cell):
    ref, port = records[ARCH, cell]
    got, want = sum(port["collectives"].values()), sum(ref["collectives"].values())
    assert 0 < got <= 1.5 * want, (port["collectives"], ref["collectives"])
    assert port["alltoall_fallbacks"] == 0  # no sweep reshards by an all-to-all


@pytest.mark.parametrize("arch,cell", list(SERVE_CELLS))
def test_lm_serving_cells_within_the_reference_bounds(records, arch, cell):
    """The returned cache split as the reference's (``out_bytes`` at most
    its), collectives a step at most 1.5x, and the cell's bound on bytes a
    device; model FLOPs equal."""
    ref, port = records[arch, cell]
    assert ref["ok"] and port["ok"]
    assert port["model_flops"] == ref["model_flops"]
    assert 0 < port["out_bytes"] <= ref["out_bytes"], (port["out_bytes"], ref["out_bytes"])
    assert 0 < port["collective_bytes"] <= 1.5 * ref["collective_bytes"], (
        port["collectives"], ref["collectives"])
    bound = SERVE_CELLS[arch, cell]
    if bound is not None:
        assert port["bytes_per_device"] <= bound * ref["bytes_per_device"], (
            port["bytes_per_device"], ref["bytes_per_device"])


def test_decode_rolls_its_cache_by_a_collective_permute(records):
    """internlm2's ``decode_32k`` moves one position of each layer's keys
    and values to the next sequence shard: ``[2, 24, 8, 1, 8, 128]`` bf16."""
    _, port = records["internlm2-1.8b", "decode_32k"]
    assert port["collectives"]["collective-permute@0"] == 2 * 24 * 8 * 8 * 128 * 2


@pytest.fixture
def pod():
    try:
        yield mesh_mod.make_production_mesh()
    finally:
        mesh_mod.release()


def test_alltoall_counted_at_the_local_shard(pod):
    """``[1024, 512]`` f32 rows over ``data``, to columns over ``data``:
    one all-to-all of the ``[1024, 32]`` local shard (131,072 bytes), none
    of the fallback's 2 MiB all-gather; the function restored after."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import _collective_utils, placement_types

    before = _collective_utils.shard_dim_alltoall
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = DTensor.from_local(torch.empty(64, 512), pod, [Shard(0), Replicate()],
                               run_check=False, shape=torch.Size((1024, 512)),
                               stride=(512, 1))
        account = dryrun.Account()
        with dryrun.counted_alltoall(account), account:
            y = x.redistribute(pod, [Shard(1), Replicate()])
        plain = dryrun.Account()
        with plain:
            x.redistribute(pod, [Shard(1), Replicate()])
    assert tuple(y.to_local().shape) == (1024, 32)
    assert account.collectives == {"all-to-all@0": 1024 * 32 * 4}
    assert account.alltoall_fallbacks == 1
    assert plain.collectives == {"all-gather@0": 1024 * 512 * 4}  # the fallback, uncounted
    assert _collective_utils.shard_dim_alltoall is before
    assert placement_types.shard_dim_alltoall is before
