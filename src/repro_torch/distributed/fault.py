"""Fault tolerance: heartbeats, straggler detection, restart-from-checkpoint.

On a 1000+ node cluster the failure model is: hosts vanish (preemption,
hardware), hosts slow down (thermal, network), and whole pods partition.
The framework's answer, mirrored here at single-process scale so it is
testable on CPU:

* ``Heartbeat``         — per-host monotonic step/time reports.
* ``StragglerMonitor``  — flags hosts whose step latency exceeds
  ``threshold x median`` over a sliding window; the launcher responds by
  excluding the host and re-sharding (elastic scale-down) at the next
  checkpoint boundary.
* ``RestartPolicy``     — drives run loops: every exception rolls back to
  the last committed checkpoint, with capped exponential backoff and a
  budget of restarts (same contract a cluster-level supervisor implements).

Deterministic data order + committed checkpoints
make replacement-host replay exact.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable


@dataclasses.dataclass
class Heartbeat:
    host: str
    step: int
    t: float


class StragglerMonitor:
    def __init__(self, window: int = 16, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self._lat: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._last: dict[str, Heartbeat] = {}

    def report(self, hb: Heartbeat) -> None:
        prev = self._last.get(hb.host)
        if prev is not None and hb.step > prev.step:
            self._lat[hb.host].append((hb.t - prev.t) / (hb.step - prev.step))
        self._last[hb.host] = hb

    def median_latency(self) -> float | None:
        all_lat = sorted(
            sum(d, start=0.0) / len(d) for d in self._lat.values() if d
        )
        if not all_lat:
            return None
        return all_lat[len(all_lat) // 2]

    def stragglers(self) -> list[str]:
        med = self.median_latency()
        if med is None or med <= 0:
            return []
        out = []
        for host, d in self._lat.items():
            if d and (sum(d) / len(d)) > self.threshold * med:
                out.append(host)
        return sorted(out)

    def forget(self, host: str) -> None:
        """Drop a host's history (a replaced/rebuilt host starts fresh)."""
        self._lat.pop(host, None)
        self._last.pop(host, None)

    def dead(self, now: float, timeout: float) -> list[str]:
        return sorted(
            h for h, hb in self._last.items() if now - hb.t > timeout
        )


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 1.0
    backoff_cap_s: float = 60.0

    def run(
        self,
        body: Callable[[int], None],
        *,
        on_restart: Callable[[int, BaseException], None] | None = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> int:
        """Run ``body(restart_idx)`` with restart-on-exception semantics.
        Returns the number of restarts consumed."""
        restarts = 0
        while True:
            try:
                body(restarts)
                return restarts
            except KeyboardInterrupt:
                raise
            except BaseException as e:  # noqa: BLE001 — supervisor semantics
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                if on_restart is not None:
                    on_restart(restarts, e)
                sleep(min(self.backoff_s * 2 ** (restarts - 1), self.backoff_cap_s))
