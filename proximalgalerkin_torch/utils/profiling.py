"""Profiling hooks: per-phase wall-clock plus optional torch.profiler
traces, the port of the reference package's utils/profiling.py.

The reference has no in-repo tracing (SURVEY.md §5 — only PETSc monitor
options and Julia @elapsed); the rebuild adds phase timers
(core/logging.PhaseTimer, threaded through NewtonSolver) and this
device-trace context, which writes a Chrome trace (TensorBoard's
`*.pt.trace.json`) of the host and, on a CUDA device, of its kernels."""

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
    or None when not enabled."""
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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the profile (record_function)."""
    with torch.profiler.record_function(name):
        yield
