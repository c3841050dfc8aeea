"""Logging, monitors and the port's one span and counter recorder.

Mirrors the reference's rank-gated printing (obstacle_pg.py:32-40) and the
PETSc monitor semantics (`snes_monitor`, `ksp_monitor` options): monitors are
callbacks invoked once per iteration with (iteration, norm).

The recorder. `span(name)` marks a layer of a solve (a context manager);
`count(name, n)` counts an event, such as a blocking device-to-host read
(`host_reads`). Tracing is on while a torch.profiler records, or inside
`tracing()`; nothing else turns it on. While it is off, a span costs one
flag test (no clock, no synchronise, nothing kept) and a count one
integer add to the process total (`counter(name)`). While it is on, a
span synchronises its device at both edges, so that it holds the device
work it enqueued, mirrors itself as the profiler range `pg.<name>`, and
is kept in memory (at most MAX_SPANS, the rest counted in `dropped`)
with its parent, its root's solve id and the counts counted while it was
the innermost open span; `recorded()` returns them grouped by root.
Start and end are in nanoseconds on the profiler's clock (Unix-epoch
nanoseconds): `perf_counter_ns` offset to it when each root opens. A
span opened while the current stream captures a CUDA graph records and
synchronises nothing. `PhaseTimer` is a per-solver view of the recorder.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, Dict, List, Optional

import torch


def process_index() -> int:
    """This process's rank in torch.distributed when that is initialised,
    else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_print(string: str, rank: int = 0, file=None) -> None:
    """Print only on one process (the multi-process analogue of MPI rank-0
    printing in the reference, obstacle_pg.py:32-40)."""
    if process_index() == rank:
        print(string, file=file or sys.stdout, flush=True)


class Monitor:
    """SNES/KSP-style iteration monitor: prints `  k NAME norm ...` lines."""

    def __init__(self, name: str, enabled: bool = False,
                 callback: Optional[Callable[[int, float], None]] = None):
        self.name = name
        self.enabled = enabled
        self.callback = callback
        self.history: list[float] = []

    def __call__(self, it: int, norm: float) -> None:
        self.history.append(float(norm))
        if self.enabled:
            rank_print(f"  {it:3d} {self.name} norm {norm:.12e}")
        if self.callback is not None:
            self.callback(it, float(norm))


# --------------------------------------------------------------- recorder

MAX_SPANS = 1_000_000
_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class Span:
    """One recorded span. start_ns and end_ns are on the profiler's clock;
    parent is the index in `Recorder.spans` of the span open when it
    began (-1 for a root or a dropped parent), solve the id its root
    gave the solve, counts what was counted while it was innermost."""

    __slots__ = ("name", "start_ns", "end_ns", "index", "parent", "solve",
                 "counts")

    def __init__(self, name: str, parent: int, solve: int):
        self.name, self.parent, self.solve = name, parent, solve
        self.start_ns = self.end_ns = 0
        self.index = -1
        self.counts: Dict[str, int] = {}


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _sync_current() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Open:
    """The context of one span while tracing is on."""

    __slots__ = ("rec", "name", "sync", "span", "mirror")

    def __init__(self, rec: "Recorder", name: str, sync: Callable):
        self.rec, self.name, self.sync = rec, name, sync
        self.span = None

    def __enter__(self):
        if _capturing():
            return self
        rec = self.rec
        self.sync()
        if rec.open:
            top = rec.open[-1]
            sp = Span(self.name, top.index, top.solve)
        else:
            rec.solves += 1
            rec.offset_ns = time.time_ns() - time.perf_counter_ns()
            sp = Span(self.name, -1, rec.solves)
        if len(rec.spans) < rec.max_spans:
            sp.index = len(rec.spans)
            rec.spans.append(sp)
        else:
            rec.dropped += 1
        rec.open.append(sp)
        self.span = sp
        sp.start_ns = time.perf_counter_ns() + rec.offset_ns
        self.mirror = torch.profiler.record_function("pg." + self.name)
        self.mirror.__enter__()
        return self

    def __exit__(self, *exc):
        sp = self.span
        if sp is None:
            return False
        self.sync()
        self.mirror.__exit__(*exc)
        sp.end_ns = time.perf_counter_ns() + self.rec.offset_ns
        self.rec.open.pop()
        return False


class Recorder:
    """Spans and counters of the process (see the module's docstring)."""

    def __init__(self):
        self.max_spans = MAX_SPANS
        self.spans: List[Span] = []
        self.dropped = 0
        self.totals: Dict[str, int] = {}
        self.open: List[Span] = []        # innermost last
        self.solves = 0
        self.offset_ns = 0
        self.forced = 0

    def on(self) -> bool:
        """Whether tracing is on: a profiler records, or inside tracing()."""
        return self.forced > 0 or _profiler_enabled()

    def span(self, name: str, sync: Optional[Callable] = None):
        """Context manager of the span `name`; sync synchronises its
        device (default: the current CUDA device, once CUDA is up)."""
        if not self.on():
            return _NULL
        return _Open(self, name, sync or _sync_current)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the process total of `name` and, while a span is
        open, to the innermost one's counts."""
        self.totals[name] = self.totals.get(name, 0) + n
        if self.open:
            c = self.open[-1].counts
            c[name] = c.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self.totals.get(name, 0)

    def recorded(self) -> List[List[Span]]:
        """The kept spans grouped by root, in the order the roots opened;
        each group's root first, then its spans in the order they
        opened."""
        groups: Dict[int, List[Span]] = {}
        for sp in self.spans:
            groups.setdefault(sp.solve, []).append(sp)
        return list(groups.values())

    def clear(self) -> None:
        """Forget the kept spans (the counters' totals run on)."""
        self.spans.clear()
        self.dropped = 0

    @contextlib.contextmanager
    def tracing(self):
        """Tracing on inside the context, with or without a profiler."""
        self.forced += 1
        try:
            yield self
        finally:
            self.forced -= 1


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
counter = RECORDER.counter
recorded = RECORDER.recorded
tracing = RECORDER.tracing


class PhaseTimer:
    """Per-phase wall-clock accumulator (assembly / linear solve / outer
    loop), the per-solver view of the recorder: phase(name) opens
    span(name) and adds the phase's seconds on the host clock to
    totals[name] and one to counts[name]. While tracing is on, the span
    synchronises `device` (a CUDA one) at both edges, before the clock is
    read, so a phase holds the device work it enqueued; while it is off
    nothing synchronises and a phase holds what the host spent in it."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    class _Ctx:
        def __init__(self, timer: "PhaseTimer", phase: str):
            self.timer, self.phase = timer, phase

        def __enter__(self):
            self.span = RECORDER.span(self.phase, self.timer._sync)
            self.span.__enter__()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.span.__exit__(*exc)
            dt = time.perf_counter() - self.t0
            self.timer.totals[self.phase] = self.timer.totals.get(self.phase, 0.0) + dt
            self.timer.counts[self.phase] = self.timer.counts.get(self.phase, 0) + 1
            return False

    def phase(self, name: str) -> "PhaseTimer._Ctx":
        return PhaseTimer._Ctx(self, name)

    def report(self) -> str:
        lines = [f"{k}: {v:.4f}s over {self.counts[k]} calls" for k, v in self.totals.items()]
        return "\n".join(lines)
