"""The check's control and the faults it must catch.

The control (every inequality applied once, no fixpoint: the configurations'
guarantee of the greatest dual simulation broken) has to come out not
correct; so does a run whose timed path is broken underneath, once for each
fault a single-card serving cell can have: a fixpoint that returns its state
unchanged, half of a microbatch's requests left out and answered with the
rest's result, and an answer altered where it is produced.  A cell on one
card has no exchange between cards to leave out.
"""
import dataclasses
import subprocess
import sys

import pytest

from dsbench import harness
from dsbench.control import control_reading
from dsbench.harness import ROOT
from dsbench.reference import dualsim as ref
from dsbench.tests._tiny import run_tiny, tiny_cell

CELLS = ("lubm30.serve", "lubm30.adhoc")


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    readings = [control_reading(tiny_cell(name), seed, 200)[0] for seed in (1, 2, 3)]
    assert all(r > 0 for r in readings), readings


def _unchanged_state(monkeypatch):
    from repro_torch.core import dualsim

    def stuck(sweep, init, max_sweeps):
        return init, 1

    monkeypatch.setattr(dualsim, "_sweep_fixpoint", stuck)


def _half_batch(monkeypatch):
    from repro_torch.engine import engine

    solve = engine.Engine._solve_microbatch

    def half(self, requests, bucket=None):
        keep = requests[: max(1, (len(requests) + 1) // 2)]
        out = solve(self, keep, bucket)
        by_idx = dict(out)
        first = out[0][1]
        return [(i, by_idx.get(i, first)) for i, _ in requests]

    monkeypatch.setattr(engine.Engine, "_solve_microbatch", half)


def _altered_answer(monkeypatch):
    from repro_torch.core import pruning

    prune = pruning.prune_triples

    def altered(soi, chi, g):
        mask, stats = prune(soi, chi, g)
        mask = mask.copy()
        mask[len(mask) // 2] ^= True
        return mask, stats

    monkeypatch.setattr(pruning, "prune_triples", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line, checks = run_tiny("lubm30.serve", seed=8, seconds=1.5)
    assert line["correct"] is False, line["checks"]
    assert dict((n, v) for n, v, _ in checks)["mismatched_bits"] > 0


def test_a_sound_run_reads_zero():
    line, checks = run_tiny("lubm30.serve", seed=8, seconds=1.5)
    assert line["correct"] is True
    assert all(v == 0 for _, v, _ in checks)


def test_judge_counts_a_missing_variable():
    cell = tiny_cell("lubm30.serve")
    corpus, requests, _, _ = harness.make_inputs(cell, 4)
    data = harness.reference_data(corpus)
    fam, text = requests.window[0]
    mask, binds = ref.answer(text, data)
    rec = harness.Record(0, fam, text, True, outcome="ok", survivors=mask, bindings=dict(binds))
    assert harness.judge([rec], data) == 0
    var = next(iter(binds))
    del rec.bindings[var]
    assert harness.judge([rec], data) == int(binds[var].sum()) + 1
    rec2 = dataclasses.replace(rec, bindings=dict(binds), survivors=~mask)
    assert harness.judge([rec2], data) == len(mask)


@pytest.mark.gpu
def test_a_cell_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")
    out = subprocess.run([sys.executable, "dsbench/run.py", "--workload", "lubm30.adhoc",
                          "--seed", "12345", "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]
