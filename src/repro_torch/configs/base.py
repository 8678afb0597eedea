"""ArchSpec of the LM family: the full config (``.cfg``) and a tiny
same-family config for CPU smoke tests (``.reduced()``).  The JAX
package's shape cells, shardings and dry-run hooks are not ported."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as tr


class LMArch:
    family = "lm"

    def __init__(self, cfg: tr.LMConfig):
        self.id = cfg.name
        self.cfg = cfg

    def reduced(self) -> tr.LMConfig:
        return dataclasses.replace(
            self.cfg,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.cfg.n_kv_heads // self.cfg.n_heads),
            d_ff=128,
            vocab=128,
            head_dim=16,
            sliding_window=8 if self.cfg.sliding_window else None,
            dtype=torch.float32,
            remat=False,
        )
