"""The port stands alone: every ``repro_torch`` module, and ``chip_smoke.py``,
imports with JAX and the JAX package made unimportable."""
import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
missing = set(sys.argv[2:]) - set(names)
assert not missing, missing
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
)
assert not leaked, leaked
print(len(names))
"""


SLICE_MODULES = (
    "repro_torch.serve",
    "repro_torch.faults",
    "repro_torch.distributed",
    "repro_torch.distributed.fault",
    "repro_torch.launch",
    "repro_torch.launch.serve",
    "repro_torch.kernels.segsum.ops",
)


def test_every_module_imports_without_jax_or_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO / "chip_smoke.py"), *SLICE_MODULES],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 46


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_file_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"
