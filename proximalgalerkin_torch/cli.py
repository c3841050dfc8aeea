"""Command-line interface of the port. One subcommand so far:

    python -m proximalgalerkin_torch bench -n 1024 [--device cuda]
        [--pc {mg,jacobi}] [--fused]

`bench` runs the north-star obstacle benchmark in this process: P1
obstacle on rectangle_mesh(n, n) over [-1,1]^2, alpha capped at 1e2,
outer increment tolerance 1e-8, mixed precision, with the fused MG-PCG
inner solve (--pc mg, the default) or the fused DIA-CG (--pc jacobi),
the counterpart of the reference's PGTPU_BENCH_PC. --fused runs
solve_fused() instead of solve() (PGTPU_BENCH_FUSED). It prints one JSON
line with the keys of the reference's bench worker (bench.py
_worker_fem) and diagnostics on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _vcycle_bytes(m: int, esz: int) -> int:
    """Modelled memory traffic of one V(1,1) cycle (the reference bench's
    model): a Jacobi sweep reads x, b, w and writes x; a residual the
    same; restrict and prolong read the source and write the target; 24
    sweeps on the coarsest level."""
    from .ops.mg import _levels_for
    from .ops.mgfused import COARSE_SWEEPS
    ms = _levels_for(m)
    total = 0
    for li, mm in enumerate(ms):
        nl, nc = mm * mm, ((mm - 1) // 2 + 1) ** 2
        if li == len(ms) - 1:
            total += COARSE_SWEEPS * 4 * nl
            continue
        total += 2 * 4 * nl + 4 * nl + 2 * (nl + nc)
    return total * esz


def run_bench(n: int, device: str, pc: str = "mg",
              fused: bool = False) -> dict:
    import torch
    from .mesh import rectangle_mesh
    from .models.obstacle_p1 import P1ObstacleSolver
    from .ops import dia_spmv, mgfused

    dev = torch.device(device)
    if dev.type == "cuda":
        t0 = time.time()
        mgfused.build()
        dia_spmv.build()
        print(f"# kernel build {time.time() - t0:.1f}s", file=sys.stderr,
              flush=True)
    t0 = time.time()
    mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    solver = P1ObstacleSolver(mesh, alpha_cap=1e2, outer_tol=1e-8,
                              mixed_precision=True, pc=pc, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"# setup {time.time() - t0:.1f}s dofs {2 * solver.N}",
          file=sys.stderr, flush=True)

    t0 = time.time()
    result = solver.solve_fused() if fused else solver.solve()
    elapsed = time.time() - t0       # both end in a device-to-host copy
    feas = float((result.u - solver.phi.cpu().numpy()).min())

    # modelled traffic of the inner CG (the reference bench's model):
    # matvec + 7 vector streams per iteration, f32, plus one V-cycle (mg)
    # or the diagonal scaling's read and write (jacobi)
    N, esz = solver.N, 4
    ndiags = solver.A_data.shape[0]
    iter_bytes = (ndiags + 2) * N * esz + 7 * N * esz
    if pc == "mg":
        iter_bytes += _vcycle_bytes(n + 1, esz)
    else:
        iter_bytes += 2 * N * esz
    gbps = result.cg_its_total * iter_bytes / max(elapsed, 1e-9) / 1e9
    return {"mode": "fem_p1", "elapsed": elapsed, "n": n,
            "dofs": 2 * solver.N, "newton": result.newton_its,
            "outer": result.outer_iterations,
            "converged": result.converged, "feasibility": feas,
            "cg_its": result.cg_its_total, "membw_gbps": round(gbps, 1),
            "esz": esz}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="proximalgalerkin_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("bench", help="north-star obstacle benchmark")
    p.add_argument("-n", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve, e.g. cuda or cpu "
                        "(default cuda)")
    p.add_argument("--pc", choices=("mg", "jacobi"), default="mg",
                   help="inner preconditioner: fused MG-PCG or fused "
                        "DIA-CG (default mg)")
    p.add_argument("--fused", action="store_true",
                   help="run solve_fused() (totals only) instead of solve()")
    args = parser.parse_args(argv)
    if args.cmd == "bench":
        print(json.dumps(run_bench(args.n, args.device, args.pc,
                                   args.fused)), flush=True)


if __name__ == "__main__":
    main()
