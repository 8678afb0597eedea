"""The port's machine probe (``repro_torch.launch.roofline``) and its spec
store (``repro_torch.engine.machine``) against the JAX package's
``benchmarks/roofline.py`` and ``repro.engine.machine``: the same fields,
the same JSON, specs that load across the two packages, and the same
``CostModel.from_spec`` constants from the same numbers.  The probe runs
here on the CPU (``backend="cpu"``, its ``--fast`` sweep); on the card it
runs in ``tests/test_torch_gpu.py``."""
import dataclasses
import json
import math

import pytest
import torch

from repro.engine import cost as ref_cost
from repro.engine import machine as ref_machine
from repro_torch.engine import cost, machine
from repro_torch.launch import roofline

RATES = ("stream_bytes_per_s", "dense_elems_per_s", "packed_words_per_s",
         "packed_words_per_s_xla", "fused_words_per_s")


@pytest.fixture(scope="module")
def probed():
    """One ``--fast`` probe of this CPU: ``(spec, detail)``."""
    return roofline.probe(fast=True, backend="cpu")


def _reference_spec(**kw) -> ref_machine.MachineSpec:
    fields = dict(
        backend="cpu", device_kind="cpu", fingerprint="ref-fp", n_devices=1,
        stream_bytes_per_s=2.0e10, dense_elems_per_s=3.0e10,
        packed_words_per_s=4.0e8, packed_words_per_s_xla=5.0e8,
        fused_words_per_s=5.0e8, kernel_launch_s=2e-4, dispatch_s=1e-4,
        trace_s=0.25, collective_bytes_per_s=None, probed_at="t", fast=True)
    fields.update(kw)
    return ref_machine.MachineSpec(**fields)


def _same_models(port_spec, ref_spec) -> None:
    got = cost.CostModel.from_spec(port_spec)
    want = ref_cost.CostModel.from_spec(ref_spec)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_spec_fields_and_version_equal_the_reference():
    port = [(f.name, f.default) for f in dataclasses.fields(machine.MachineSpec)]
    ref = [(f.name, f.default) for f in dataclasses.fields(ref_machine.MachineSpec)]
    assert port == ref
    assert machine.SPEC_VERSION == ref_machine.SPEC_VERSION
    assert machine.ENV_VAR == ref_machine.ENV_VAR


def test_xor_word_is_the_reference_constant():
    assert roofline.XOR_WORD & 0xFFFFFFFF == 0x9E3779B9


def test_cpu_probe_gives_finite_positive_rates(probed):
    spec, detail = probed
    assert spec.version == machine.SPEC_VERSION
    assert (spec.backend, spec.device_kind, spec.n_devices, spec.fast) == ("cpu", "cpu", 1, True)
    assert spec.fingerprint == machine.machine_fingerprint("cpu")
    assert spec.fingerprint.startswith("torch-")
    for name in RATES + ("kernel_launch_s", "dispatch_s"):
        value = getattr(spec, name)
        assert math.isfinite(value) and value > 0, name
    assert math.isfinite(spec.trace_s) and spec.trace_s >= 0
    assert spec.collective_bytes_per_s is None and detail["collective"] is None
    # the reference's extraction: peaks and cheapest calls over the rows
    assert [r["words"] for r in detail["stream"]["rows"]] == [1 << 20, 1 << 22]
    assert spec.stream_bytes_per_s == max(r["bytes_per_s"] for r in detail["stream"]["rows"])
    assert spec.dense_elems_per_s == max(r["elems_per_s"] for r in detail["dense"]["rows"])
    ship, xla = detail["bitop"]["shipping"], detail["bitop"]["xla"]
    assert [r["n"] for r in ship["rows"]] == [64, 512]
    assert [r["n"] for r in xla["rows"]] == [64, 1024, 2048]
    assert spec.kernel_launch_s == min(r["seconds"] for r in ship["rows"])
    assert spec.dispatch_s == min(r["seconds"] for r in xla["rows"])
    assert spec.packed_words_per_s == max(r["words"] / r["seconds"] for r in ship["rows"])
    assert spec.fused_words_per_s == spec.packed_words_per_s_xla  # the CPU ships words


def test_to_json_keys_equal_the_reference(probed):
    spec, _ = probed
    assert sorted(spec.to_json()) == sorted(_reference_spec().to_json())
    assert spec.to_json() == dataclasses.asdict(spec)


def test_port_spec_loads_in_the_reference_with_the_same_cost_model(probed, tmp_path):
    spec, _ = probed
    path = machine.save_spec(spec, str(tmp_path / "port.json"))
    loaded = ref_machine.load_spec(path)
    assert loaded.to_json() == spec.to_json()
    _same_models(spec, loaded)
    assert machine.load_spec(path) == spec


def test_reference_spec_loads_in_the_port(tmp_path):
    for kw in ({}, dict(backend="tpu", collective_bytes_per_s=1.0e11, n_devices=4)):
        ref_spec = _reference_spec(**kw)
        path = ref_machine.save_spec(ref_spec, str(tmp_path / "ref.json"))
        loaded = machine.load_spec(path)
        assert loaded.to_json() == ref_spec.to_json()
        _same_models(loaded, ref_spec)


def test_save_spec_is_atomic_and_clears_the_memo(tmp_path, monkeypatch):
    monkeypatch.setattr(machine, "SPEC_DIR", str(tmp_path))
    monkeypatch.delenv(machine.ENV_VAR, raising=False)
    machine.clear_spec_cache()
    assert machine.default_spec("cpu") is None  # unset, nothing saved yet
    spec = dataclasses.replace(
        machine.load_spec(ref_machine.save_spec(_reference_spec(), str(tmp_path / "r.json"))),
        fingerprint=machine.machine_fingerprint("cpu"))
    path = machine.save_spec(spec)  # default path: SPEC_DIR/<fingerprint>.json
    assert path == machine.spec_path(spec.fingerprint)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["r.json", f"{spec.fingerprint}.json"])  # no temporary file left
    assert machine.default_spec("cpu") == spec  # the memo was cleared
    with open(path) as f:
        assert json.load(f) == spec.to_json()
    machine.clear_spec_cache()


def test_default_spec_honours_the_environment(tmp_path, monkeypatch):
    monkeypatch.setattr(machine, "SPEC_DIR", str(tmp_path))
    spec = dataclasses.replace(
        machine.load_spec(ref_machine.save_spec(_reference_spec(), str(tmp_path / "r.json"))),
        fingerprint=machine.machine_fingerprint("cpu"))
    machine.save_spec(spec)
    pinned = machine.save_spec(dataclasses.replace(spec, trace_s=9.0),
                               str(tmp_path / "pinned.json"))
    for value, want in (("off", None), ("0", None), ("none", None), (pinned, 9.0)):
        monkeypatch.setenv(machine.ENV_VAR, value)
        got = machine.default_spec("cpu")
        assert (got.trace_s if got else None) == want, value
    monkeypatch.delenv(machine.ENV_VAR)
    assert machine.default_spec("cpu") == spec  # unset: SPEC_DIR/<fingerprint>.json
    assert machine.default_spec("cuda") is None  # another fingerprint, none saved
    assert cost.resolve_model(backend="cpu").source == spec.fingerprint
    machine.clear_spec_cache()


def test_cli_prints_a_spec_the_reference_loads(capsys, tmp_path):
    assert roofline.main(["--fast", "--no-save", "--json", "--backend", "cpu"]) == 0
    raw = json.loads(capsys.readouterr().out)
    assert raw["backend"] == "cpu" and raw["version"] == machine.SPEC_VERSION
    ref_spec = ref_machine.MachineSpec(**raw)
    _same_models(machine.MachineSpec(**raw), ref_spec)


def test_card_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        roofline.probe(fast=True, backend="cuda")
    with pytest.raises(RuntimeError):
        roofline.stream_probe(fast=True)


def test_graphdb_spec_prices_its_plans(probed):
    """``GraphDB(spec=)`` prices every plan with that spec (its reason
    cites the spec's fingerprint), and answers as the hand-tuned model's
    database does."""
    import numpy as np

    from repro_torch.core import sparql
    from repro_torch.data import synth
    from repro_torch.db import GraphDB
    from repro_torch.engine import canonicalize

    spec, _ = probed
    g = synth.lubm_like(n_universities=2, seed=0)
    text = sparql.format_query(synth.lubm_l1_like())
    calibrated, hand = GraphDB(g, device="cpu", spec=spec), GraphDB(g, device="cpu")
    assert calibrated._engine.spec is spec and hand._engine.spec is None
    got, want = calibrated.query(text), hand.query(text)
    plan, hit = calibrated._engine.plan_for(canonicalize(sparql.parse(text)))
    assert hit and f"[{spec.fingerprint}]" in plan.cost.reason
    assert np.array_equal(got.survivor_mask, want.survivor_mask)
    for v in want.variables:
        assert np.array_equal(got.binding_mask(v), want.binding_mask(v))


def test_card_fingerprint_folds_in_the_pricing_version(monkeypatch, tmp_path):
    """A card's fingerprint keeps the ``torch-`` prefix, backend, kind and
    host shape, and hashes the pricing version with the host name: a spec
    saved under the earlier fingerprint is never looked up by default."""
    import hashlib
    import os
    import platform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    got = machine.machine_fingerprint("cuda")
    head = f"torch-cuda__NVIDIA-H100-80GB-HBM3__{platform.machine()}__{os.cpu_count()}__1__"
    earlier = head + hashlib.blake2b(platform.node().encode(), digest_size=4).hexdigest()
    node = f"{platform.node()}|pricing-{machine.CARD_PRICING_VERSION}"
    assert got == head + hashlib.blake2b(node.encode(), digest_size=4).hexdigest()
    assert got != earlier and machine.CARD_PRICING_VERSION >= 2
    # the CPU's fingerprint hashes the host name alone, as before
    assert machine.machine_fingerprint("cpu").endswith(
        hashlib.blake2b(platform.node().encode(), digest_size=4).hexdigest())
    monkeypatch.setattr(machine, "SPEC_DIR", str(tmp_path))
    monkeypatch.delenv(machine.ENV_VAR, raising=False)
    machine.clear_spec_cache()
    old = dataclasses.replace(
        machine.load_spec(ref_machine.save_spec(_reference_spec(), str(tmp_path / "r.json"))),
        backend="cuda", fingerprint=earlier)
    machine.save_spec(old)
    assert machine.default_spec("cuda") is None
    machine.save_spec(dataclasses.replace(old, fingerprint=got))
    assert machine.default_spec("cuda").fingerprint == got
    machine.clear_spec_cache()


def test_packed_operand_packs_like_the_graph():
    """The probe's device-built operand equals ``pack_np`` of the bool plane
    of the same random edges, with no ``[n, n]`` plane made."""
    import numpy as np

    from repro_torch.core import bitops

    for n in (1, 33, 100, 257):
        a = roofline.packed_operand(n, torch.Generator().manual_seed(n), torch.device("cpu"))
        src, dst = roofline._random_edges(n, torch.Generator().manual_seed(n),
                                          torch.device("cpu"))
        plane = np.zeros((n, n), dtype=bool)
        plane[src.numpy(), dst.numpy()] = True
        assert a.dtype == torch.int32 and a.shape == (n, bitops.packed_width(n))
        assert np.array_equal(a.numpy().view(np.uint32), bitops.pack_np(plane))


def test_fit_recovers_launch_and_rate():
    """``seconds = launch + work / rate`` fitted back from exact rows; a
    fit that would put the launch below 0 holds it at 0."""
    rows = [dict(work=w, seconds=7e-5 + w / 4e12) for w in (1e4, 1e6, 1e8, 1e9, 2e9)]
    launch, rate = roofline.fit_launch_rate(rows)
    assert launch == pytest.approx(7e-5, rel=1e-9) and rate == pytest.approx(4e12, rel=1e-9)
    rows = [dict(work=w, seconds=w / 1e9 - 1e-4) for w in (1e6, 1e7, 1e8)]
    launch, rate = roofline.fit_launch_rate(rows)
    assert launch == 0.0 and math.isfinite(rate) and rate > 0


def test_card_rows_run_on_the_cpu_at_small_sizes(monkeypatch):
    """The card's bit-op and dense rows (here on the CPU's plain versions
    at small shapes): every (n, V, density) row with its set bits, work and
    fitted seconds, both fits finite, and the dense rows with the product
    timed alone."""
    monkeypatch.setattr(roofline, "CARD_BITOP_NS", (64, 200))
    monkeypatch.setattr(roofline, "CARD_BITOP_VS", (3, 8))
    monkeypatch.setattr(roofline, "CARD_DENSITIES", (0.1, 0.5))
    monkeypatch.setattr(roofline, "CARD_DENSE_NS", (64, 128))
    monkeypatch.setattr(roofline, "CARD_DENSE_VS", (3, 16))
    cpu = torch.device("cpu")
    card = roofline.card_bitop_rows(cpu, fast=False, repeats=1)
    for key in ("fused", "packed"):
        fit = card[key]
        assert [(r["n"], r["v"], r["density"]) for r in fit["rows"]] == [
            (n, v, d) for n in (64, 200) for v in (3, 8) for d in (0.1, 0.5)]
        for r in fit["rows"]:
            assert 0 < r["bits"] <= r["n"] * r["v"]
            assert r["work"] == r["bits"] * ((r["n"] + 31) // 32)
            assert r["fit_seconds"] == pytest.approx(
                fit["launch_s"] + r["work"] / fit["words_per_s"])
        assert fit["launch_s"] >= 0 and math.isfinite(fit["words_per_s"])
        assert fit["words_per_s"] > 0
    fast = roofline.card_bitop_rows(cpu, fast=True, repeats=1)
    assert [(r["n"], r["v"]) for r in fast["fused"]["rows"]] == [(64, 3)]
    rows = roofline.card_dense_rows(cpu, fast=False, repeats=1)
    assert [(r["n"], r["v"]) for r in rows] == [(64, 3), (64, 16), (128, 3), (128, 16)]
    for r in rows:
        assert r["seconds"] > 0 and r["product_seconds"] > 0
        assert r["elems_per_s"] == r["v"] * r["n"] ** 2 / r["seconds"]
