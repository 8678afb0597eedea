"""Microbatching: disjoint-union SOIs and template-keyed request queues
(DESIGN.md 5.4).

``batched_soi`` (moved here from ``launch/serve.py``) forms the disjoint
union of per-request SOIs — variables get per-instance copies, so one
fixpoint solves the whole batch; instances never interact because no
inequality crosses an instance boundary.  Variables are renamed with a
*per-instance index* suffix (``{base}#{i}``), so instance boundaries are
reconstructible for result demux: :func:`batch_layout` records the variable
offset of every instance.

``MicroBatcher`` groups pending requests by template key and pads each group
to a bucketed batch size (1, 2, 4, ...), so a handful of compiled plans —
one per (template, bucket) — serve any request mix with zero retraces.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

from repro_torch.core.soi import SOI

from .template import TemplateInstance

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)


def batched_soi(parts: Sequence[SOI]) -> SOI:
    """Disjoint union of per-request SOIs (no shared variables).

    Instance ``i``'s variables are renamed ``{base}#{i}`` and occupy the
    contiguous id block ``[offsets[i], offsets[i] + parts[i].n_vars)`` — see
    :func:`batch_layout` for the demux view.
    """
    return batch_layout(parts).soi


@dataclasses.dataclass
class BatchLayout:
    """A batched SOI plus the per-instance demux information."""

    soi: SOI
    parts: list[SOI]
    offsets: list[int]  # instance i -> first internal var id

    def chi_slice(self, i: int) -> slice:
        """Row slice of the batched chi belonging to instance ``i``."""
        return slice(self.offsets[i], self.offsets[i] + self.parts[i].n_vars)


def batch_layout(parts: Iterable[SOI]) -> BatchLayout:
    """Disjoint-union SOI plus per-instance offsets for result demux."""
    parts = list(parts)
    base: list[str] = []
    is_const: list[str | None] = []
    edge, copy, pe = [], [], []
    offsets = []
    for i, s in enumerate(parts):
        off = len(base)
        offsets.append(off)
        base += [f"{b}#{i}" for b in s.base]
        is_const += s.is_const
        edge += [(l + off, r + off, a, d) for (l, r, a, d) in s.edge_ineqs]
        copy += [(l + off, r + off) for (l, r) in s.copy_ineqs]
        pe += [(v + off, a, w + off) for (v, a, w) in s.pattern_edges]
    union = SOI(
        base=base, is_const=is_const, edge_ineqs=edge, copy_ineqs=copy,
        pattern_edges=pe, external_mand={}, external_opt={},
    )
    return BatchLayout(soi=union, parts=parts, offsets=offsets)


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (largest bucket caps the microbatch size)."""
    for b in buckets:
        if b >= n:
            return b
    return max(buckets)


@dataclasses.dataclass
class Microbatch:
    """A group of same-template requests to be solved as one fixpoint."""

    template_key: str
    requests: list[tuple[int, TemplateInstance]]  # (caller index, instance)
    bucket: int


class MicroBatcher:
    """Queue requests, then drain them as template-grouped microbatches.

    Grouping is by template key: requests that share a plan (same query
    shape) batch together regardless of their constants.  Each group is
    chunked at the largest bucket and padded up to the smallest bucket that
    fits, so the set of (template, bucket) plans stays small.
    """

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self._queues: dict[str, list[tuple[int, TemplateInstance]]] = {}

    def add(self, index: int, instance: TemplateInstance) -> None:
        """Queue one request under its template key for the next drain."""
        self._queues.setdefault(instance.template.key, []).append(
            (index, instance)
        )

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def drain(self) -> Iterator[Microbatch]:
        """Yield microbatches (FIFO within a template) and empty the queues.

        Requests are deduplicated by constant tuple *before* chunking:
        duplicate submits share one instance slot at execution, so they must
        not consume chunk capacity — 20 identical submits at cap 16 are ONE
        solve, not two.  Chunks hold up to ``max(buckets)`` unique tuples
        (FIFO by first occurrence) and the bucket is sized for that unique
        count, naming the (template, bucket) plan the executor will use.
        """
        cap = max(self.buckets)
        for key, queue in self._queues.items():
            groups: dict[tuple[str, ...], list[tuple[int, TemplateInstance]]] = {}
            for idx, inst in queue:
                groups.setdefault(inst.constants, []).append((idx, inst))
            uniq = list(groups.values())
            for s in range(0, len(uniq), cap):
                chunk = uniq[s : s + cap]
                yield Microbatch(
                    template_key=key,
                    requests=[r for grp in chunk for r in grp],
                    bucket=bucket_for(len(chunk), self.buckets),
                )
        self._queues.clear()
