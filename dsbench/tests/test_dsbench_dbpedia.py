"""The DBpedia-shaped generator and the ``dbpedia3m.serve`` cell: seeded,
Zipf-shaped, and run whole at a tiny size on the CPU."""
import copy
import json

import numpy as np
import pytest

from dsbench import harness
from dsbench.data import dbpedia
from dsbench.harness import BENCH
from dsbench.tests.test_dsbench_harness import _schema

CELL = "dbpedia3m.serve"
TINY = {"triples": 20_000, "nodes": 6_000}


def _config(**over):
    with open(BENCH / "configs" / "dbpedia-3m.json") as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def test_same_seed_same_triples():
    cfg = _config(**TINY)
    a = dbpedia.generate(cfg, np.random.default_rng(11))
    b = dbpedia.generate(cfg, np.random.default_rng(11))
    c = dbpedia.generate(cfg, np.random.default_rng(12))
    assert np.array_equal(a.triples, b.triples)
    assert a.node_names == b.node_names and a.label_names == b.label_names
    assert not np.array_equal(a.triples, c.triples)


def test_counts_come_from_size_seed():
    cfg = _config()
    counts = dbpedia.predicate_counts(cfg)
    assert counts.sum() == cfg["triples"] and len(counts) == cfg["predicates"]
    assert np.array_equal(counts, dbpedia.predicate_counts(cfg))
    assert np.array_equal(dbpedia.node_order(cfg), dbpedia.node_order(_config()))
    other = _config(size_seed=cfg["size_seed"] + 1)
    assert not np.array_equal(counts, dbpedia.predicate_counts(other))
    assert not np.array_equal(dbpedia.node_order(cfg), dbpedia.node_order(other))
    # the run's seed draws the wiring, never the drawn counts
    tiny = _config(**TINY)
    a = dbpedia.generate(tiny, np.random.default_rng(1))
    b = dbpedia.generate(tiny, np.random.default_rng(2))
    assert a.counts["triples drawn"] == b.counts["triples drawn"] == TINY["triples"]
    assert abs(len(a.triples) - len(b.triples)) <= 0.01 * TINY["triples"]


def test_predicate_sizes_follow_one_over_rank():
    cfg = _config()
    counts = dbpedia.predicate_counts(cfg)
    h = (1.0 / np.arange(1, cfg["predicates"] + 1)).sum()
    want = cfg["triples"] / h / np.arange(1, 101)
    assert np.all(np.abs(counts[:100] - want) <= 0.02 * want)
    assert np.all(np.diff(counts[:100]) <= 0)


def test_the_hub_holds_its_zipf_share_of_endpoints():
    cfg = _config(**TINY)
    c = dbpedia.generate(cfg, np.random.default_rng(7))
    hub = dbpedia.node_order(cfg)[0]
    want = 1.0 / (1.0 / np.arange(1, cfg["nodes"] + 1)).sum()  # 1 / H(nodes)
    for col in (0, 2):
        ends = np.bincount(c.triples[:, col], minlength=cfg["nodes"])
        assert ends.argmax() == hub
        assert abs(ends[hub] / len(c.triples) - want) <= 0.2 * want


def _tiny_cell():
    cell = copy.deepcopy(harness.find_cell(CELL))
    cell.config.update(TINY)
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_with_the_last_line_schema(trace):
    line, _ = harness.run_cell(_tiny_cell(), 2**31 + 77, 1.5, bool(trace), device="cpu",
                               log=lambda s: None)
    _schema(line, trace)
    assert line["correct"], line["checks"]
    cell = harness.find_cell(CELL)
    want = {m["name"] for m in cell.metrics["per_layer" if trace else "end_to_end"]}
    got = set(line["metrics"])
    # on the CPU the device's own metrics find nothing to read
    device_only = {"k1_roofline", "device_idle_pct", "chi_copy_ms_per_query"}
    assert want - device_only <= got <= want
    if trace:
        assert line["metrics"]["solve_copies_ms_per_query"]["value"] > 0


def test_every_family_holds_an_optional_and_draws_from_its_objects():
    cell = harness.find_cell(CELL)
    assert cell.chips == 1 and cell.config["generator"] == "dbpedia"
    for fam in cell.mix["families"]:
        assert "OPTIONAL" in fam["text"] and "UNION" not in fam["text"]
        for pool in fam.get("constants", []):
            assert pool.startswith("objects:p") and f" {pool[8:]} %0" in fam["text"]
    assert sum(f["count"] for f in cell.mix["families"]) == 64
