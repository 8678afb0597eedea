"""Machine capability specs for the calibrated cost model (DESIGN.md 13).

A :class:`MachineSpec` is the output of the port's ERT-style probe
(:mod:`repro_torch.launch.roofline`, the twin of the JAX package's
``benchmarks/roofline.py``): a handful of measured machine ceilings —
sustained streaming bandwidth, packed bit-op throughput under the shipping
and the word-wise XLA lowerings, dense boolean-matmul efficiency, per-call
kernel-launch and XLA-dispatch overheads, the jit trace+compile latency,
and (on a mesh) per-byte collective cost.  :func:`repro_torch.engine.cost.
CostModel.from_spec` turns those ceilings into the per-engine cost
constants, replacing the hand-tuned defaults that encode one developer
machine.

The fields and their JSON are the reference's.  On a card three of them
measure the port's own kernels instead: ``fused_words_per_s`` and
``kernel_launch_s`` are the rate and intercept of K2's fit (``bitmm_apply``
timed across the dense tier's shapes, per OR'd word: a set frontier bit
times a column word), and ``packed_words_per_s`` the rate of the packed
engine's step fitted alike (:func:`repro_torch.launch.roofline.
card_bitop_rows`).

Specs are persisted as versioned JSON under ``results/machine/`` keyed by a
:func:`machine_fingerprint` (backend + device kind + host shape), so CI
runners and dev machines each calibrate against their own measurements and
the perf gate (``tools/perfgate``) never compares trajectories across
machines.

Resolution order for :func:`default_spec` (what the cost model consults
when no spec is passed explicitly):

* ``REPRO_MACHINE_SPEC=off`` (or ``0``/``none``) — calibration disabled;
  the hand-tuned model is used.  The test suite pins this for determinism.
* ``REPRO_MACHINE_SPEC=<path>`` — load exactly that spec file.
* unset — look up ``results/machine/<fingerprint>.json`` for the current
  machine; hand-tuned fallback when absent.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import tempfile

SPEC_VERSION = 1
# What a card's spec measures: 2 since the probe fits the port's own
# kernels (K2's launch and rate by set frontier bits, the packed engine's
# step; launch/roofline.py).  Hashed into a card's fingerprint, so a spec
# saved under an earlier meaning is never looked up by default.
CARD_PRICING_VERSION = 2
ENV_VAR = "REPRO_MACHINE_SPEC"
SPEC_DIR = os.path.normpath(
    os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results", "machine"
    )
)


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Measured machine ceilings, the probe's persisted output.

    Rates are per second of sustained throughput (best over repeats);
    overheads and the trace latency are seconds per call.  ``fast`` records
    whether the probe ran its reduced CI sweep (fewer sizes/repeats) —
    fast specs are still valid calibration, just noisier.
    """

    backend: str  # backend the probe ran on ("cpu", "cuda", ...)
    device_kind: str  # device kind string (e.g. "cpu", a card's name)
    fingerprint: str  # machine_fingerprint() at probe time
    n_devices: int  # visible device count at probe time
    stream_bytes_per_s: float  # sustained streaming bandwidth (uint32 traffic)
    dense_elems_per_s: float  # dense f32-matmul boolean-product elements/s
    # on a card: the packed engine's step (K3 + its unpacked AND), fitted
    # per OR'd word (a set frontier bit and column word)
    packed_words_per_s: float  # bitmm_apply words/s, shipping lowering
    packed_words_per_s_xla: float  # bitmm_apply words/s, word-wise XLA lowering
    # on a card: K2's rate, fitted per OR'd word
    fused_words_per_s: float  # fused-path words/s, shipping lowering
    # on a card: the intercept of K2's fit
    kernel_launch_s: float  # per-call overhead of the shipping kernel path
    dispatch_s: float  # per-call overhead of a compiled XLA op
    trace_s: float  # jit trace+compile of a representative packed fixpoint
    collective_bytes_per_s: float | None = None  # None below 2 devices
    probed_at: str = ""  # ISO timestamp (informational only)
    fast: bool = False  # reduced --fast sweep
    version: int = SPEC_VERSION

    def to_json(self) -> dict:
        """Plain-dict form for persistence (round-trips via ``load_spec``)."""
        return dataclasses.asdict(self)


def machine_fingerprint(backend: str = "cuda") -> str:
    """Stable id of (backend, device kind, host shape) for spec keying.

    ``backend`` is a torch device type (``"cuda"`` or ``"cpu"``); the kind
    is ``torch.cuda.get_device_name()`` on a card and ``"cpu"`` otherwise.
    Includes the CPU architecture, core count, device count, and a short
    hostname hash so a CI runner never inherits (or pollutes) a dev
    machine's calibration or perf-gate history: an unseen fingerprint
    bootstraps a fresh trajectory instead of cross-comparing.  The
    ``torch-`` prefix keeps the port off specs that the JAX package's probe
    calibrated for its own lowerings on the same host.  A card's hashed
    part also folds in :data:`CARD_PRICING_VERSION`.
    """
    import torch

    hashed = platform.node()
    if backend == "cuda" and torch.cuda.is_available():
        devices = list(range(torch.cuda.device_count()))
        kind = torch.cuda.get_device_name(0)
        hashed += f"|pricing-{CARD_PRICING_VERSION}"
    else:
        devices = [0]
        kind = "cpu"
    node = hashlib.blake2b(hashed.encode(), digest_size=4).hexdigest()
    raw = "__".join(
        str(p)
        for p in (
            backend, kind.replace(" ", "-"), platform.machine(),
            os.cpu_count(), len(devices), node,
        )
    )
    return "torch-" + raw.replace("/", "-")


def spec_path(fingerprint: str) -> str:
    """Where a spec with this fingerprint persists under ``results/machine/``."""
    return os.path.join(SPEC_DIR, f"{fingerprint}.json")


def save_spec(spec: MachineSpec, path: str | None = None) -> str:
    """Persist ``spec`` as JSON (atomic rename) and return the path."""
    path = path or spec_path(spec.fingerprint)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(spec.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    clear_spec_cache()
    return path


def load_spec(path: str) -> MachineSpec:
    """Load a persisted spec, tolerating fields added by later versions."""
    with open(path) as f:
        raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(MachineSpec)}
    return MachineSpec(**{k: v for k, v in raw.items() if k in fields})


_cache: dict[tuple[str | None, str], MachineSpec | None] = {}


def clear_spec_cache() -> None:
    """Drop memoized :func:`default_spec` results (tests, fresh probes)."""
    _cache.clear()


def default_spec(backend: str = "cuda") -> MachineSpec | None:
    """The spec the cost model should use when none is passed explicitly.

    Honors ``REPRO_MACHINE_SPEC`` (see module docstring); memoized per
    (env value, backend) so the per-plan cost of consulting it is a dict
    lookup, not disk I/O.
    """
    env = os.environ.get(ENV_VAR)
    key = (env, backend)
    if key in _cache:
        return _cache[key]
    spec: MachineSpec | None
    if env is not None and env.strip().lower() in ("off", "0", "none", ""):
        spec = None
    elif env is not None:
        spec = load_spec(env)
    else:
        path = spec_path(machine_fingerprint(backend))
        spec = load_spec(path) if os.path.exists(path) else None
    _cache[key] = spec
    return spec
