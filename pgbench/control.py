"""The controls of a cell's comparison, and the program's readings on
many seeds, in one process (set-up is long; a run needs no window).

    python3 pgbench/control.py --workload <cell> --seeds 11 12 13 \
        [--kinds program,rounded_f32,...]

For each seed it reads, as --kinds asks:
  program        the program as the configuration states it (the
                 lower readings);
  rounded_f32    the program's answer with its fields rounded to
                 float32 (the state in the precision below the stated
                 one);
  program_f32    the program's own float32 path (dtype float32);
  reference_f32  the reference in float32 put in the program's place,
                 where the reference can solve the problem itself.
Each answer is judged by the cell's reference; one JSON line per
reading. A control has to come out not correct on every seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from pgbench import harness, inputs as inputs_mod  # noqa: E402


KINDS = ("program", "rounded_f32", "program_f32", "reference_f32")


def readings(cell, seed: int, device, kinds=KINDS) -> list:
    """[(kind, counts, numbers, correct)] of one seed."""
    import torch
    driver, reference = cell.driver(), cell.reference()
    inp = inputs_mod.make(cell.config, cell.workload["params"], seed)
    ctx = reference.prepare(inp, cell.config)
    out = []

    def judge(kind, counts, fields):
        nums = reference.numbers(ctx, fields)
        ok = all(harness.finite(v) and v <= reference.LIMITS[k]
                 for k, v in nums.items())
        out.append((kind, counts, nums, ok))

    runs = [(k, dt) for k, dt in (("program", torch.float64),
                                  ("program_f32", torch.float32))
            if k in kinds or (k == "program" and "rounded_f32" in kinds)]
    for kind, dtype in runs:
        state = driver.setup(cell.config, cell.workload, inp, device,
                             dtype=dtype)
        t0 = time.perf_counter()
        ans = driver.solve(state)
        counts = dict(ans.counts, seconds=time.perf_counter() - t0,
                      converged=ans.converged, **ans.extra)
        if kind in kinds:
            judge(kind, counts, ans.fields)
        if kind == "program" and "rounded_f32" in kinds:
            judge("rounded_f32", counts,
                  {k: v.astype(np.float32).astype(np.float64)
                   for k, v in ans.fields.items()})
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if "reference_f32" in kinds and hasattr(reference, "solve"):
        ref32 = reference.solve(inp, cell.config, dtype=np.float32)
        judge("reference_f32", {"newton": ref32["newton"],
                                "converged": ref32["converged"]}, ref32)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="comma-separated readings to take (default all)")
    args = ap.parse_args(argv)
    import torch
    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        for kind, counts, nums, ok in readings(
                cell, seed, device, args.kinds.split(",")):
            print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind,
                              "correct": ok, "numbers": nums,
                              "counts": counts}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
