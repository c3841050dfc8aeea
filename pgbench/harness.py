"""The general part of the benchmark: it finds a cell's files by name,
drives the window or the traced solve, reduces the trace and assembles
the result line. What belongs to one configuration, traffic mix or
metric lives in files of its own:

    BENCHMARK.json                  cells and metrics (the checkout root)
    pgbench/configs/<config>.json   sizes, source, driver
    pgbench/workloads/<cell>.json   traffic parameters and why
    pgbench/drivers/<driver>.py     set-up, warm-up, one solve, counts
    pgbench/reference/<config>.py   the plain reference and its limits
    pgbench/metrics/<metric>.py     one reader a metric

A driver module defines
    setup(config, workload, inputs, device) -> state
    warmup(state)
    solve(state) -> Answer        one solve from the initial state,
                                  ending in a device-to-host copy
A reference module defines
    LIMITS                         {number: limit}
    prepare(inputs, config) -> ctx its own operators (and solution)
    numbers(ctx, fields) -> {number: value}   one answer's readings
    (a number is within its limit when value <= limit)
A metric module defines
    read(record) -> float or None (None: nothing to read here)
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
import time
from bisect import bisect_right
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import roofline

FORBIDDEN = ("jax", "jaxlib", "flax", "proximalgalerkin_tpu")


@dataclass
class Answer:
    """One solve's outcome: its counts (compared across the window),
    whether it converged, and its fields per mesh vertex."""
    counts: dict
    converged: bool
    fields: Dict[str, np.ndarray]
    extra: dict = field(default_factory=dict)

    def digest(self) -> str:
        h = hashlib.sha256()
        for k in sorted(self.fields):
            h.update(k.encode())
            h.update(np.ascontiguousarray(self.fields[k]).tobytes())
        return h.hexdigest()


def load_module(path: Path, name: str):
    """Import the file at path as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    spec: dict                 # BENCHMARK.json
    entry: dict                # its workloads entry
    workload: dict             # pgbench/workloads/<cell>.json
    config: dict               # pgbench/configs/<config>.json
    bench: Path                # the pgbench directory

    def driver(self):
        return load_module(self.bench / "drivers" / f"{self.config['driver']}.py",
                           f"pgbench_driver_{self.config['driver']}")

    def reference(self):
        return load_module(self.bench / "reference" / f"{self.config['name']}.py",
                           f"pgbench_reference_{self.config['name']}")

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        trace its per-layer ones."""
        e2e = [m for m in self.spec["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           f"pgbench_metric_{metric.replace('.', '_')}")


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    entry = entries[0]
    bench = root / spec["paths"][0]
    workload = json.loads((bench / "workloads" / f"{name}.json").read_text())
    if workload["config"] != entry["config"] or \
            workload["traffic"] != entry["traffic"]:
        raise ValueError(f"{name}: workload file and BENCHMARK.json differ "
                         "on config or traffic")
    cfgs = [c for c in spec["configs"] if c["name"] == entry["config"]]
    config = json.loads((root / cfgs[0]["file"]).read_text())
    return Cell(name, spec, entry, workload, config, bench)


def forbidden_loaded() -> List[str]:
    """Modules in sys.modules whose whole top-level name is forbidden."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# ----------------------------------------------------------------- window

@dataclass
class Window:
    seconds: float
    attempted: int
    failed: int
    solves_ok: int
    answers: List[Answer]          # distinct answers, first one first
    weights: List[int]             # how many solves gave each
    first: Optional[Answer]
    mismatches: List[str]


def run_window(driver, state, seconds: float) -> Window:
    """Solve again and again from the same initial state; stop at the
    first solve that ends after `seconds`. A solve that does not
    converge, or whose counts differ from the first's, counts in
    failed. Answers are kept once per distinct content."""
    attempted = failed = ok = 0
    first = None
    seen: Dict[str, Answer] = {}
    times: Dict[str, int] = {}
    mismatches: List[str] = []
    t0 = time.perf_counter()
    while True:
        attempted += 1
        ans = driver.solve(state)
        t1 = time.perf_counter()
        if first is None:
            first = ans
        good = ans.converged and ans.counts == first.counts
        if good:
            ok += 1
        else:
            failed += 1
            mismatches.append(f"solve {attempted}: converged "
                              f"{ans.converged}, counts {ans.counts} "
                              f"(first {first.counts})")
        key = ans.digest()
        seen.setdefault(key, ans)
        times[key] = times.get(key, 0) + 1
        if t1 - t0 >= seconds:
            break
    return Window(t1 - t0, attempted, failed, ok, list(seen.values()),
                  [times[k] for k in seen], first, mismatches)


# ------------------------------------------------------------------ trace

def _span(e) -> Tuple[int, int]:
    """(start, end) in ns of a profiler event, across torch versions."""
    if hasattr(e, "start_ns"):
        a = e.start_ns()
        return a, (e.end_ns() if hasattr(e, "end_ns")
                   else a + e.duration_ns())
    a = e.start_us() * 1000
    return a, a + e.duration_us() * 1000


def _on_device(e) -> bool:
    """A device operation: a kernel, copy or set on the card (not a
    user annotation mirrored on the device's timeline)."""
    if "cuda" not in str(e.device_type()).lower():
        return False
    if hasattr(e, "activity_type"):
        kind = str(e.activity_type()).lower()
        return any(k in kind for k in ("kernel", "memcpy", "memset"))
    user = getattr(e, "is_user_annotation", None)
    return not (user() if user else e.name().startswith("pgbench."))


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


# the breakdown's entries a list, and the longest idle gaps labelled
TOP = 10
GAPS_KEPT = 4000


def summarize_trace(events, window: Tuple[int, int]) -> dict:
    """Reduce raw profiler events to the record the readers take.

    events: the profiler's kineto events (name(), device_type(), the
    span in ns, and activity_type() where torch has it). window: the
    traced solve's (start_ns, end_ns) on the profiler's clock.
    Returns busy_s (union of device intervals inside the window),
    window_s, kernels {name: [seconds, launches]}, device_ops (the top
    device operations by time) and idle_gaps (the longest idle gaps,
    summed by the innermost host operation open at their middle)."""
    w0, w1 = window
    dev, host = [], []
    for e in events:
        a0, b0 = _span(e)
        if _on_device(e):
            a, b = max(a0, w0), min(b0, w1)
            if b > a:
                dev.append((a, b, e.name()))
        elif "cpu" in str(e.device_type()).lower() \
                and not e.name().startswith("pgbench."):
            host.append((a0, b0, e.name()))
    kernels: Dict[str, List[float]] = {}
    for a, b, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) * 1e-9
        k[1] += 1
    spans = sorted((a, b) for a, b, _ in dev)
    busy = roofline.union_seconds((a * 1e-9, b * 1e-9) for a, b in spans)
    # idle gaps between merged device intervals, and before the first
    gaps = []
    end = w0
    for a, b in spans:
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((w1 - end, end, w1))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    labels: Dict[str, float] = {}
    for length, a, b in gaps[:GAPS_KEPT]:
        mid = (a + b) // 2
        i = bisect_right(starts, mid)
        label = "(python)"
        for j in range(i - 1, max(i - 400, 0) - 1, -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        labels[label] = labels.get(label, 0.0) + length * 1e-9
    by_time = sorted(((_short(n), v[0]) for n, v in kernels.items()),
                     key=lambda kv: -kv[1])
    merged: Dict[str, float] = {}
    for n, s in by_time:
        merged[n] = merged.get(n, 0.0) + s
    return {
        "busy_s": busy,
        "window_s": (w1 - w0) * 1e-9,
        "kernels": kernels,
        "device_ops": sorted(merged.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(labels.items(), key=lambda kv: -kv[1])[:TOP],
    }


def _profiled(driver, state, device, host: bool):
    """One solve under torch.profiler; returns (answer, events, window,
    wall seconds). With host activity the window is the span of a
    `pgbench.window` annotation around the solve; a device-only trace
    records no host span, so there a one-element fill on the device just
    before and just after the solve brackets the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = device.type == "cuda"
    host = host or not cuda
    acts = ([ProfilerActivity.CPU] if host else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    marker = torch.zeros(1, device=device)
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function("pgbench.window"):
            t0 = time.perf_counter()
            marker.fill_(1.0)
            ans = driver.solve(state)
            marker.fill_(2.0)
            if cuda:
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    if host:
        marks = [_span(e) for e in events if e.name() == "pgbench.window"
                 and "cpu" in str(e.device_type()).lower()]
    else:
        spans = [_span(e) for e in events if _on_device(e)]
        marks = [(min(a for a, _ in spans), max(b for _, b in spans))] \
            if spans else []
    if not marks:
        raise RuntimeError("the profiler recorded no window")
    return ans, events, marks[0], wall


def traced_solve(driver, state, device, phases=None
                 ) -> Tuple[Answer, dict]:
    """Two traced solves. The first records the device alone (the
    lightest trace): busy_s, window_s, kernel times, device_ops, and
    the driver's phase times over it. The second records host and
    device, and gives only the labels of the idle gaps. Returns the
    first solve's answer and the summary."""
    before = phases(state) if phases else {}
    ans, events, window, wall = _profiled(driver, state, device, False)
    after = phases(state) if phases else {}
    summary = summarize_trace(events, window)
    summary["solve_wall_s"] = wall
    summary["phases"] = {k: v - before.get(k, 0.0) for k, v in after.items()}
    del events
    second, events, window, _ = _profiled(driver, state, device, True)
    summary["idle_gaps"] = summarize_trace(events, window)["idle_gaps"]
    summary["second_counts_equal"] = second.counts == ans.counts
    return ans, summary


# ----------------------------------------------------------------- result

def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: List[Tuple[str, float, float]],
                breakdown: Optional[dict] = None) -> str:
    """The contract's last line; the numbers compared come last, each
    with its limit."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)


def finite(x) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)
