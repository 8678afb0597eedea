"""Fault-tolerant checkpointing in the JAX package's layout.

Layout: ``<dir>/step_<N>/`` containing one ``.npy`` per leaf (flattened tree
paths as file names), a ``manifest.json`` with the tree, step and integrity
hashes, and a ``COMMIT`` marker written last — a half-written checkpoint
(host died mid-save) is never considered loadable.

* **async** — ``save(..., background=True)`` runs serialization on a worker
  thread; the caller blocks only on the device->host copy, which finishes
  before the thread starts.
* **integrity** — sha256 per leaf, verified on load.

A tree is nested dicts (keys in sorted order, as the JAX package flattens
them), lists and tuples, with tensors or numpy arrays as leaves.  Leaves
are written, hashed and read on a small thread pool (file I/O and hashing
release the interpreter lock).  A DTensor leaf is saved whole (gathered).
``restore`` places each leaf on the device of the matching leaf of
``like``, or, given ``shardings``, re-shards it onto whatever mesh the new
job runs with (elastic restore), as a DTensor.
"""
from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.shard import leaves_with_path

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
_IO_THREADS = 8


def _leaves(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in the JAX package's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in _leaves(x, path + (i,))]
    return [(path, tree)]


def _rebuild(like: Any, fn: Callable[[tuple, Any], Any], path: tuple = ()) -> Any:
    """``like``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, fn, path + (i,)) for i, x in enumerate(like))
    return fn(path, like)


def _leaf_name(path: tuple) -> str:
    return _SAFE.sub("_", "/".join(str(k) for k in path)) or "root"


def _to_host(leaf: Any) -> np.ndarray:
    """A host copy of a leaf that later in-place updates do not reach (a
    DTensor's whole value)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def _pool_map(fn, items: list) -> list:
    with cf.ThreadPoolExecutor(min(_IO_THREADS, max(len(items), 1))) as ex:
        return list(ex.map(fn, items))


def save(
    ckpt_dir: str,
    step: int,
    tree: Any,
    *,
    background: bool = False,
    keep: int = 3,
) -> threading.Thread | None:
    """Write a checkpoint; returns the worker thread if background=True."""
    # device->host happens here (the only synchronous part)
    host = [(_leaf_name(p), _to_host(leaf)) for p, leaf in _leaves(tree)]

    def _write():
        out = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = out + ".tmp"
        os.makedirs(tmp, exist_ok=True)

        def one(item):
            name, arr = item
            fn = os.path.join(tmp, name + ".npy")
            np.save(fn, arr)
            return {"name": name, "shape": list(arr.shape), "dtype": str(arr.dtype),
                    "sha256": _sha256(fn)}

        manifest = {"step": step, "leaves": _pool_map(one, host)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.isdir(out):
            shutil.rmtree(out)
        os.rename(tmp, out)
        _gc(ckpt_dir, keep)

    if background:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "COMMIT")):
            out.append(int(m.group(1)))
    return sorted(out)


def restore(
    ckpt_dir: str,
    like: Any,
    *,
    step: int | None = None,
    shardings: Any = None,
    verify: bool = True,
) -> tuple[Any, int]:
    """Load the latest (or given) committed step into the structure of
    ``like``: each leaf becomes a tensor on the device of ``like``'s leaf
    (the CPU for a leaf that is not a tensor), or, given ``shardings`` (a
    tree of :class:`repro_torch.distributed.shard.NamedSharding` with
    ``like``'s paths), a DTensor placed on its sharding's mesh."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    base = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    digests = {l["name"]: l["sha256"] for l in manifest["leaves"]}

    def load(path: tuple) -> np.ndarray:
        name = _leaf_name(path)
        fn = os.path.join(base, name + ".npy")
        if verify and _sha256(fn) != digests[name]:
            raise IOError(f"checksum mismatch for {name}")
        return np.load(fn)

    paths = [p for p, _ in _leaves(like)]
    arrays = dict(zip(paths, _pool_map(load, paths)))

    by_path = dict(leaves_with_path(shardings)) if shardings is not None else None

    def place(path: tuple, leaf: Any) -> torch.Tensor:
        host = torch.from_numpy(arrays[path])
        if by_path is not None:
            ns = by_path["/".join(str(k) for k in path)]
            return distribute_tensor(host.to(ns.mesh.device_type), ns.mesh, ns.placements)
        device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        return host.to(device)

    return _rebuild(like, place), step
