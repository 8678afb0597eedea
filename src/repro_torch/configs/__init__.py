"""Architecture registry: ``get(arch_id)`` returns an ArchSpec.

The port holds every architecture of the JAX package: the LM configs
(dense and MoE), the GNN configs, the recsys config and the
dual-simulation workloads.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "internlm2-1.8b",
    "qwen3-8b",
    "yi-6b",
    "olmoe-1b-7b",
    "mixtral-8x7b",
    "gatedgcn",
    "gat-cora",
    "pna",
    "schnet",
    "dcn-v2",
    "dualsim-lubm",
    "dualsim-dbpedia",
]


def get(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; "
                       f"the port has {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}"
    )
    return mod.SPEC
