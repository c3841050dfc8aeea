"""Run one cell of the port's benchmark once and print its result line.

    python3 pgbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's files are found by name (see
harness.py). Set-up (imports, kernel build, mesh, the solver, its
warm-up) is timed as setup_s. With --trace 0 the run then solves the
cell's problem again and again for --seconds and reports the cell's
end-to-end metrics; with --trace 1 it solves once under torch.profiler
and reports the per-layer metrics, busy_s, window_s and a breakdown.
Either way every answer is judged by the plain reference once the
window has closed. The last line of standard output is one JSON
object; the numbers compared, with their limits, are the last lines of
standard error and the last key of that object. The run fails, with no
result, without enough CUDA devices, or when a JAX module is loaded.
Host thread pools are held to two threads.
"""

import os
import time

T_START = time.perf_counter()

# one process with few threads: host thread pools sized before numpy
# and torch load, so that a run's host work does not spread over (and
# wait on) the machine's other cores
THREADS = "2"
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = THREADS

import argparse  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pgbench import harness, inputs as inputs_mod  # noqa: E402


def run_cell(cell: "harness.Cell", seed: int, seconds: float, trace: bool,
             device, t_start: float, driver=None) -> dict:
    """Set up, warm up, measure and judge one run of `cell` on `device`.
    Returns {"line": the result object, "checks": [(name, value,
    limit)], "mismatches": [...]}."""
    import torch
    driver = driver or cell.driver()
    reference = cell.reference()
    inp = inputs_mod.make(cell.config, cell.workload["params"], seed)
    state = driver.setup(cell.config, cell.workload, inp, device)
    driver.warmup(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    log = []
    t_window = time.perf_counter()
    record = {"cell": cell.name, "config": cell.config,
              "params": cell.workload["params"], "setup_s": setup_s}
    if trace:
        ans, summary = harness.traced_solve(
            driver, state, device, getattr(driver, "phases", None))
        record.update(trace=summary, phases=summary["phases"],
                      solve_s=summary["solve_wall_s"])
        answers, weights = [ans], [1]
        attempted, failed, mismatches = 1, 0, []
        if not (ans.converged and summary["second_counts_equal"]):
            failed = 1
            mismatches.append("the traced solve did not converge, or the "
                              "second traced solve's counts differ")
        first = ans
    else:
        win = harness.run_window(driver, state, seconds)
        record.update(window_s=win.seconds, solves_ok=win.solves_ok)
        answers, weights = win.answers, win.weights
        attempted, failed = win.attempted, win.failed
        mismatches, first = win.mismatches, win.first
    record["counts"], record["extra"] = first.counts, first.extra

    log.append(f"setup_s {setup_s:.3f}; window or traced solves "
               f"{time.perf_counter() - t_window:.3f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference judges every distinct answer once the window closed
    t_ref = time.perf_counter()
    ctx = reference.prepare(inp, cell.config)
    worst = {k: 0.0 for k in reference.LIMITS}
    for ans, w in zip(answers, weights):
        nums = reference.numbers(ctx, ans.fields)
        bad = False
        for k, v in nums.items():
            ok = harness.finite(v) and v <= reference.LIMITS[k]
            bad = bad or not ok
            worst[k] = v if not harness.finite(v) else max(worst[k], v)
        if bad:
            failed += w
            mismatches.append(f"an answer given {w} time(s) fails the "
                              f"reference: {nums}")
    log.append(f"reference {time.perf_counter() - t_ref:.3f} s for "
               f"{len(answers)} distinct answer(s) of {attempted} solves")
    checks = [(k, worst[k], reference.LIMITS[k]) for k in reference.LIMITS]
    correct = all(harness.finite(v) and v <= lim for _, v, lim in checks)
    failed = min(failed, attempted)

    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
        breakdown = {k: [[n, s] for n, s in record["trace"][k]]
                     for k in ("device_ops", "idle_gaps")}
    line = harness.result_line(correct, attempted, failed, metrics, dev,
                               checks, breakdown)
    return {"line": line, "checks": checks, "mismatches": mismatches,
            "log": log,
            "counts": first.counts, "extra": first.extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(int(THREADS))
    cell = harness.load_cell(ROOT, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for m in out["log"] + out["mismatches"]:
        print(f"# {m}", file=sys.stderr)
    print(f"# counts {out['counts']} extra {out['extra']}", file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(out["line"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
