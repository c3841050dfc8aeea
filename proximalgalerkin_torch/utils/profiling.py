"""The port's trace exporter, the counterpart of the reference package's
utils/profiling.py.

The reference has no in-repo tracing (SURVEY.md §5 — only PETSc monitor
options and Julia @elapsed). The port's spans and counters live in
core/logging (`span`, `count`, `tracing`, `recorded`; `PhaseTimer` is a
view of them). This device-trace context writes a Chrome trace
(TensorBoard's `*.pt.trace.json`) of the host and, on a CUDA device, of
its kernels; while it records, the program's spans are on and appear in
it as the ranges `pg.<name>`."""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: str = "pgtorch_trace", enabled: bool = True
                 ) -> Iterator[Optional[torch.profiler.profile]]:
    """Capture a torch.profiler trace of everything inside the context
    (CPU activity, and CUDA activity when a card is present) into a
    `*.pt.trace.json` file in `logdir`:

        with device_trace("trace"):
            solver.solve()

    Yields the profiler (its key_averages() are read after the context),
    or None when not enabled. Mark a region of one's own with
    core.logging.span(name), which the trace shows as `pg.<name>`."""
    if not enabled:
        yield None
        return
    Path(logdir).mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)))
    with prof:
        yield prof

