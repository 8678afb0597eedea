"""The check's control: the reference with one guarantee broken, put in the
program's place, must come out not correct.

    python dsbench/control.py --workload <name> --seeds <n> [<n> ...] [--requests N]

For each seed it builds the cell's corpus and request sequence at the cell's
size, takes the first ``N`` requests as if all were answered, picks the
sample the benchmark's check would (``harness.check_sample``), answers each
sampled request with the control (every inequality applied once to the
start values, no fixpoint, which breaks the configurations' guarantee that
answers are the greatest dual simulation), and prints the bits by which
those answers differ from the reference's: the check's ``mismatched_bits``,
whose limit is 0.  It needs no card and runs none of the program.
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def control_reading(cell, seed: int, n_requests: int) -> tuple[int, int]:
    """(mismatched bits of the control's answers, requests sampled)."""
    from dsbench import harness
    from dsbench.reference import dualsim as ref

    corpus, requests, checked, check_rng = harness.make_inputs(cell, seed)
    data = harness.reference_data(corpus)
    records = []
    for i in range(min(n_requests, len(requests.window))):
        fam, text = requests.window[i]
        rec = harness.Record(i, fam, text, bool(checked[i]), outcome="ok")
        records.append(rec)
    sample = harness.check_sample(records, check_rng, cell.check["check_max"])
    for rec in sample:
        rec.survivors, rec.bindings = ref.answer(rec.text, data, control=True)
    return harness.judge(sample, data), len(sample)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=400,
                    help="requests taken as answered (about one window's worth)")
    args = ap.parse_args()
    from dsbench import harness

    cell = harness.find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        bad, n = control_reading(cell, seed, args.requests)
        print(f"control {args.workload} seed {seed}: mismatched_bits {bad} over {n} "
              f"sampled answers (limit 0) in {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
