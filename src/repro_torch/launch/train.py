"""End-to-end training entry point of the LM family (dense and MoE).

Wires together: config registry -> parameters on the device -> deterministic
data pipeline -> train step -> async checkpointing -> restart policy +
straggler monitor.  Runs on the card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --reduced --steps 20 --device cpu --ckpt-dir <dir>

``main(argv)`` returns one :class:`Attempt` per run of the loop (a failure
injected with ``--inject-failure-at`` makes two), so tests and scripts can
drive it in process.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.data import pipeline
from repro_torch.distributed import fault
from repro_torch.models import steps as steps_mod
from repro_torch.models import transformer as tr
from repro_torch.optimizer import adamw

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Attempt:
    """One run of the training loop, from ``start`` (the restored step)."""

    start: int
    losses: dict[int, float] = dataclasses.field(default_factory=dict)
    step_seconds: dict[int, float] = dataclasses.field(default_factory=dict)
    restore_seconds: float | None = None  # None: nothing to restore
    save_seconds: list[float] = dataclasses.field(default_factory=list)  # blocking part


OPT_CFG = adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=10_000)


def build(arch: str, reduced: bool, dtype: torch.dtype | None = None):
    spec = configs.get(arch)
    cfg = spec.reduced() if reduced else spec.cfg
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    step = steps_mod.make_train_step(
        lambda p, b: tr.loss_fn(cfg, p, b), OPT_CFG, microbatches=1
    )
    return cfg, OPT_CFG, step


def _state(model: torch.nn.Module, opt_state: dict) -> dict:
    """The checkpointed tree: parameters by name, and the AdamW state."""
    return {"params": dict(model.named_parameters()), "opt": opt_state}


def main(argv: list[str] | None = None) -> list[Attempt]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=[a for a in configs.ARCH_IDS if configs.get(a).family == "lm"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3,
                    help="committed checkpoints kept on disk")
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a node failure at this step (testing)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="activation dtype (default: the config's)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, opt_cfg, step = build(args.arch, args.reduced,
                               DTYPES[args.dtype] if args.dtype else None)
    corpus = pipeline.synthetic_corpus(cfg.vocab, 2_000_000, seed=0)
    monitor = fault.StragglerMonitor()
    attempts: list[Attempt] = []

    def run(restart_idx: int) -> None:
        model = tr.init_params(cfg, 0, device=device)
        opt_state = adamw.init(list(model.parameters()))
        att = Attempt(start=0)
        attempts.append(att)
        try:
            t0 = time.perf_counter()
            state, att.start = ckpt.restore(args.ckpt_dir, _state(model, opt_state))
        except FileNotFoundError:
            pass
        else:
            with torch.no_grad():
                for p, saved in zip(model.parameters(), state["params"].values()):
                    p.copy_(saved)
            opt_state = state["opt"]
            att.restore_seconds = time.perf_counter() - t0
            print(f"[restore] resumed from step {att.start} "
                  f"({att.restore_seconds:.2f} s)")

        batches = pipeline.token_batches(
            corpus, batch=args.batch, seq=args.seq, seed=1,
            shard=pipeline.ShardSpec(0, 1), start_step=att.start,
        )
        pending = None
        try:
            for s in range(att.start, args.steps):
                if s == args.inject_failure_at and restart_idx == 0:
                    raise RuntimeError("injected node failure")
                b = next(batches)
                t0 = time.perf_counter()
                metrics = step(model, opt_state,
                               {k: torch.as_tensor(v, device=device) for k, v in b.items()})
                att.losses[s] = float(metrics["loss"])  # waits for the step
                att.step_seconds[s] = time.perf_counter() - t0
                monitor.report(fault.Heartbeat("host0", s, time.time()))
                if s % 10 == 0:
                    print(f"step {s:5d} loss {att.losses[s]:.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"({att.step_seconds[s] * 1e3:.0f} ms)")
                if (s + 1) % args.ckpt_every == 0:
                    if pending is not None:
                        pending.join()
                    t0 = time.perf_counter()
                    pending = ckpt.save(args.ckpt_dir, s + 1, _state(model, opt_state),
                                        background=True, keep=args.keep)
                    att.save_seconds.append(time.perf_counter() - t0)
        finally:
            # a save that started before a failure still commits: the next
            # attempt must not read a half-written step, nor race its writer
            if pending is not None:
                pending.join()
        ckpt.save(args.ckpt_dir, args.steps, _state(model, opt_state), keep=args.keep)
        if monitor.stragglers():
            print("[warn] stragglers:", monitor.stragglers())
        print("done.")

    policy = fault.RestartPolicy(max_restarts=3, backoff_s=0.1)
    restarts = policy.run(
        run,
        on_restart=lambda i, e: print(f"[restart {i}] after {e!r}"))
    print(f"training completed with {restarts} restart(s)")
    return attempts


if __name__ == "__main__":
    main()
