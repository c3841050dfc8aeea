"""Readings of the program's own spans and counters (the recorder of
proximalgalerkin_torch.core.logging), for the per-layer metrics that
read them.

In a --trace 1 run tracing is on only during the harness's two traced
solves. A reader takes the first solve recorded under the root span it
names: the first traced solve, whose wall the record holds as solve_s.
A program without the recorder, or a solve that records no such root,
gives None and raises nothing."""

from __future__ import annotations

from typing import Iterable, List, Optional


def first_solve(root: str) -> Optional[List]:
    """The spans of the first solve recorded under the root span `root`
    (the root first), or None."""
    try:
        from proximalgalerkin_torch.core import logging as pglog
    except ImportError:
        return None
    recorded = getattr(pglog, "recorded", None)
    if recorded is None:
        return None
    for group in recorded():
        if group and group[0].name == root and group[0].parent < 0:
            return group
    return None


def _seconds(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-9 if s.end_ns else 0.0


def seconds(group, names: Iterable[str]) -> float:
    """Summed seconds of the spans named `names`."""
    names = set(names)
    return sum(_seconds(s) for s in group if s.name in names)


def self_seconds(group, names: Iterable[str]) -> float:
    """Summed self time of the spans named `names`: each one's seconds
    less those of its direct children."""
    names = set(names)
    own = {s.index: _seconds(s) for s in group if s.name in names}
    for s in group:
        if s.parent in own:
            own[s.parent] -= _seconds(s)
    return sum(own.values())


def counted(group, name: str) -> int:
    """The counter `name` summed over the solve's spans."""
    return sum(s.counts.get(name, 0) for s in group)


def share(record: dict, secs: float) -> Optional[float]:
    """secs as a share (%) of the traced solve's seconds."""
    total = record.get("solve_s")
    if not total or secs <= 0:
        return None
    return 100.0 * secs / total
