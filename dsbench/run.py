"""Run one benchmark cell once on the card and print its result line.

    python dsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Earlier lines of standard output record
the card, the corpus, the engine and sweeps per query family and the
requests' fates; the last line is one JSON object.  The numbers the check
compared, each with its limit, are the last lines of standard error.  A run
that finds no card, or fewer cards than the cell asks for, or JAX or the JAX
package loaded once the window has closed, exits non-zero and prints no
result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel and compiler caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
# only the checkout's root and the program's sources: no module of dsbench/
# may shadow a library module by its file name
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def card_line() -> str:
    """The card's name and power limit (``nvidia-smi``), as chip_smoke.py
    reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    t_torch = time.perf_counter() - T_PROCESS
    from dsbench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"dsbench: the cell needs {cell.chips} card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"imported {t_torch:.2f}s after the start", flush=True)
    line, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                    device="cuda", t_process=T_PROCESS,
                                    log=lambda s: print(s, flush=True))
    found = harness.loaded_jax_modules()
    if found:
        print(f"dsbench: JAX or the JAX package is loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
