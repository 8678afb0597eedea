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
    "repro_torch.launch.roofline",
    "repro_torch.kernels.segsum.ops",
    "repro_torch.kernels.bitmm.ops",
    "repro_torch.distributed.ctx",
    "repro_torch.core.join",
    "repro_torch.core.hhk",
    "repro_torch.core.ma_baseline",
    "repro_torch.data.pipeline",
    "repro_torch.optimizer",
    "repro_torch.optimizer.adamw",
    "repro_torch.optimizer.compress",
    "repro_torch.models",
    "repro_torch.models.transformer",
    "repro_torch.models.steps",
    "repro_torch.checkpoint",
    "repro_torch.checkpoint.ckpt",
    "repro_torch.configs",
    "repro_torch.configs.base",
    "repro_torch.configs.internlm2_1_8b",
    "repro_torch.configs.qwen3_8b",
    "repro_torch.configs.yi_6b",
    "repro_torch.launch.train",
    "repro_torch.models.gnn",
    "repro_torch.models.sampler",
    "repro_torch.configs.olmoe_1b_7b",
    "repro_torch.configs.mixtral_8x7b",
    "repro_torch.configs.gatedgcn",
    "repro_torch.configs.gat_cora",
    "repro_torch.configs.pna",
    "repro_torch.configs.schnet",
    "repro_torch.models.recsys",
    "repro_torch.configs.dcn_v2",
    "repro_torch.configs.dualsim_base",
    "repro_torch.configs.dualsim_lubm",
    "repro_torch.configs.dualsim_dbpedia",
    "repro_torch.distributed.shard",
    "repro_torch.launch.mesh",
    "repro_torch.launch.dryrun",
)


def test_every_module_imports_without_jax_or_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO / "chip_smoke.py"), *SLICE_MODULES],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 82


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


def test_every_reference_module_has_a_counterpart():
    """The port mirrors the JAX package module for module."""
    ref = REPO / "src" / "repro"
    missing = [str(p.relative_to(ref)) for p in sorted(ref.rglob("*.py"))
               if "__pycache__" not in p.parts and not (PORT / p.relative_to(ref)).exists()]
    assert not missing, missing


def test_arch_ids_equal_the_reference():
    from repro import configs as ref_configs
    from repro_torch import configs

    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 12
    for arch in configs.ARCH_IDS:
        assert configs.get(arch).id == arch
