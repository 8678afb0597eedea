"""The harness: cells, mixes and metrics found by name, the last line's
schema, and the imports of everything under ``dsbench/``."""
import ast
import json
import math
import shutil
import subprocess
import sys

import pytest

from dsbench import harness
from dsbench.harness import BENCH, ROOT
from dsbench.tests._tiny import run_tiny

CELLS = ("lubm30.serve", "lubm30.adhoc")
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _benchmark():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_a_cell_mix_and_metric_added_as_files_are_found(tmp_path, monkeypatch):
    bench = tmp_path / "dsbench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    mix = json.loads((BENCH / "traffic" / "lubm-serve.json").read_text())
    mix["clients"] = 7
    (bench / "traffic" / "lubm-seven.json").write_text(json.dumps(mix))
    (bench / "workloads" / "lubm30.seven.json").write_text(
        json.dumps({"check_share": 0.5, "check_max": 3}))
    (bench / "metrics" / "answered_share.py").write_text(
        "def read(run):\n    return 100.0 * len(run.answered) / max(len(run.records), 1)\n")
    bm = _benchmark()
    bm["workloads"].append({"name": "lubm30.seven", "config": "lubm-30",
                            "traffic": "lubm-seven", "chips": 1, "why": "a test"})
    bm["per_layer"].append({"name": "answered_share", "unit": "%", "better": "higher",
                            "source": "program_counter", "layer": "serving",
                            "moves": "queries_per_s", "workloads": ["lubm30.seven"]})
    monkeypatch.setattr(harness, "BENCH", bench)
    cell = harness.find_cell("lubm30.seven", benchmark=bm)
    assert cell.mix["clients"] == 7 and cell.check["check_max"] == 3
    assert [m["name"] for m in cell.metrics["per_layer"]] == ["answered_share"]
    assert {m["name"] for m in cell.metrics["end_to_end"]} == {
        "queries_per_s", "query_p50_ms", "setup_s"}
    assert cell.metrics["per_layer"][0]["layer"] == "serving"
    assert harness.reader("answered_share")(
        type("R", (), {"answered": [1, 2], "records": [1, 2, 3, 4]})()) == 50.0


def test_every_metric_has_a_reader():
    bm = _benchmark()
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]


def _schema(line, trace):
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert isinstance(line["attempted"], int) and isinstance(line["failed"], int)
    dev = line["device"]
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in dev
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"]), name
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    if trace:
        assert "busy_s" in dev and "window_s" in dev
        for key in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][key]) <= 10
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_last_line_schema(name, trace):
    line, checks = run_tiny(name, trace=bool(trace))
    _schema(line, trace)
    assert line["correct"], line["checks"]
    cell = harness.find_cell(name)
    want = {m["name"] for m in cell.metrics["per_layer" if trace else "end_to_end"]}
    got = set(line["metrics"])
    # on the CPU the device's own metrics find nothing to read
    device_only = {"k1_roofline", "device_idle_pct", "chi_copy_ms_per_query"}
    assert want - device_only <= got <= want


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "dsbench/run.py", "--workload", "lubm30.adhoc",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip().endswith("}")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_and_a_reference_of_its_own():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & BANNED, (path, tops & BANNED)
        if "reference" in path.parts:
            assert tops <= {"numpy", "re", "dataclasses", "__future__"}, (path, tops)


def test_loaded_jax_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert harness.loaded_jax_modules() == [m for m in ("repro",) if m in sys.modules]
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.loaded_jax_modules()


def test_adhoc_requests_ride_alone_on_both_replicas():
    logs: list[str] = []
    line, _ = run_tiny("lubm30.adhoc", seconds=3.0, log=logs.append)
    assert line["correct"]
    replicas = [s for s in logs if s.startswith("replica ")]
    assert len(replicas) == 2, logs
    assert all("riders a batch 1-1" in s for s in replicas), replicas


def test_k1_bytes_count_distinct_rows_not_the_bucket():
    from dsbench import yardstick
    from dsbench.traced import Summary

    cell = harness.find_cell("lubm30.serve")
    text = "{ ?X type GraduateStudent . ?X takesCourse U0_D0_GraduateCourse%d }"
    key = (("t",), 16, 2, 0.01, 0.02)  # one microbatch in a bucket of 16
    recs = []
    for i, c in enumerate((0, 1, 1)):  # two distinct constant sets, three riders
        r = harness.Record(i, "Q1", text % c, False, outcome="ok", t_done=1.0)
        r.engine, r.sweeps, r.microbatch = "sparse", 2, key
        recs.append(r)
    systems = {r.text: harness.ref.build(harness.ref.parse(r.text)) for r in recs}
    labels = {"type": 1000, "takesCourse": 500}
    run = harness.Run(cell=cell, setup_s=1.0, window_s=1.0, t_end=1.0, records=recs, stages={},
                      plan_builds=0, n_nodes=6400, label_edges=labels, systems=systems,
                      summary=Summary(window_s=1.0, busy_s=1.0,
                                      device_s={"segor_blocks_kernel": 1e-6}, idle_gaps=[]))
    sys_ = systems[recs[0].text]
    edges = [labels[a] for a in sys_.operators() if a in labels]
    want = yardstick.k1_microbatch_bytes(2, 2 * sys_.n_vars, 6400, edges)
    got = harness.reader("k1_roofline")(run)
    assert got == pytest.approx(100.0 * want / yardstick.HBM_BYTES_PER_S / 1e-6)
