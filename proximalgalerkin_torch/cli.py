"""Command-line interface of the port:

    python -m proximalgalerkin_torch [--opt KEY=VALUE ...] <subcommand>

    obstacle [-p 1|2] [--alpha-scheme S] [--disk-res R] [--rectangle N]
        [--output-dir DIR] [--n-devices N [--pc jacobi|btlu]]
    obstacle-fd [-N 65]
    obstacle-spectral [--degrees 8 16 ...] [--solve-dtype f64|f32_refine]
    compare-all [--disk-res 0.1] [--max-iter 500] [--tol 1e-4]
    signorini [--degree 1] [--disp -0.10] [--res 0.04] [--E 2e4] [--nu 0.3]
        [--alpha_scheme doubling] [--alpha_0 0.005]
    fracture [--res 0.05] [--Tmin 0] [--Tmax 5] [--num-load-steps 1001]
    multiphase [-N 50] [-M 50] [--dt 1e-5] [--T 7e-3] [--alpha_scheme S]
        [-s 1e-5]
    thermoforming [-M 150] [--compare]
    gradient-constraint [-N 200] [-M 200] [--primal_degree 2]
        [--alpha_scheme doubling] [--warm_start] [-s 1e-8]
    eigenvalue [-N 100] [--degree 3]
    intersecting [--cells 1001]
    eikonal [--ns 48] [--nt 6] [--geometry mobius|star|ball] [--res 0.08]
    monge-ampere [--kmin 3] [--kmax 14]
    bench -n 1024 [--mode fem|fd|stream] [--pc {mg,jacobi}] [--fused]
        [--esz 4|8]

The model subcommands are the reference CLI's of the same names, with its
flags, defaults and printed lines. `--opt KEY=VALUE` (repeatable, before
the subcommand) passes PETSc-style solver options to the models that take
them (signorini, fracture, multiphase, thermoforming,
gradient-constraint, eigenvalue, eikonal), with the reference's coercion
of VALUE (int, float, true/false, else a string): e.g. `--opt
pc_type=btlu` solves each Newton system with the device block-tridiagonal
factor, and `--opt snes_fused=true --opt pc_type=btlu --opt pc_factor_lag=1 --opt pc_factor_dtype=f64` runs
multiphase through the fused lagged-btlu Newton; `--opt ksp_type=minres`
runs eikonal through block-Schur MINRES, and `--opt ksp_type=minres --opt
pc_type=schur_mg --opt ksp_precision=mixed --opt pc_schur_field0=psi`
gradient-constraint through the lattice-multigrid Schur preconditioner.
`--n-devices N` runs obstacle and fracture dof-partitioned over N
subdomains (parallel/dofpart.py), all of them in this process on
--device: the reference's multi-device paths, with the subdomains on the
shard axis of one card (NCCL takes one card a process, parallel/comm.py).
The distributed obstacle's direction is `--pc jacobi` (the default, the
reference CLI's Jacobi-preconditioned MINRES) or `--pc btlu` (restricted
additive Schwarz with a block-tridiagonal subdomain factor under
GMRES(120), f64, relative tolerance 1e-11); `--rectangle N` solves on
the N x N right-diagonal mesh of [-1, 1]^2 in place of the disk.

`bench` runs one of the reference bench's workers in this process and
prints one JSON line with that worker's keys, diagnostics on stderr:
  --mode fem (default, bench.py _worker_fem): the north-star obstacle
    benchmark, P1 obstacle on rectangle_mesh(n, n) over [-1,1]^2, alpha
    capped at 1e2, outer increment tolerance 1e-8, mixed precision, with
    the fused MG-PCG inner solve (--pc mg, the default) or the fused
    DIA-CG (--pc jacobi), the counterpart of the reference's
    PGTPU_BENCH_PC; --fused runs solve_fused() instead of solve()
    (PGTPU_BENCH_FUSED);
  --mode fd (_worker_fd): the FD obstacle at N = n + 1, outer tolerance
    1e-8 (the bench's PGTPU_BENCH_TOL default), after a warm-up run at
    max_outer=1 (its seconds in warmup_s);
  --mode stream (_worker_stream): the device memory rate of a 3-stream
    axpy recurrence (u, v <- v, (u + v) / 2, one torch.lerp a chain and
    trip) in the --esz dtype, from a least-squares fit of seconds against
    trip counts, with 1 chain of 1.0 GB buffers and 4 independent chains
    of 0.6 GB each, as the reference's (a working set far beyond the
    card's 50 MB L2), torch.cuda.synchronize as the barrier.

Every subcommand runs on --device (default cuda).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


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
    setup = time.time() - t0
    print(f"# setup {setup:.1f}s dofs {2 * solver.N}", file=sys.stderr,
          flush=True)

    # warm-up at bench shapes, as the reference bench's (bench.py:76-86):
    # one Newton solve at alpha 1 from u = 0, psi = 1 captures the inner
    # solver's chunk graphs outside the timed window; it returns its
    # iterate and changes no state of the solver
    t0 = time.time()
    warmup_newton(solver)
    warmup = time.time() - t0
    print(f"# warmup {warmup:.1f}s", file=sys.stderr, flush=True)

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
            "esz": esz, "setup_s": setup, "warmup_s": warmup}


def warmup_newton(solver) -> None:
    """One Newton solve of `solver` (a P1ObstacleSolver) at alpha 1 from
    u = 0, psi = 1 (the reference bench's warm-up), synchronised."""
    import torch
    z = torch.zeros(solver.N, dtype=solver.dtype, device=solver.device)
    solver._newton(z, torch.ones_like(z), z, z, 1.0)
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)


def run_bench_fd(n: int, device: str) -> dict:
    """The reference bench's FD worker (bench.py _worker_fd) at its
    default tolerance 1e-8: a warm-up run at max_outer=1, then the timed
    run, at N = n + 1."""
    import torch
    from .models.obstacle_fd import fd_obstacle_solve
    dev = torch.device(device)
    tol = 1e-8
    t0 = time.time()
    fd_obstacle_solve(n + 1, outer_tol=tol, max_outer=1, device=dev)
    warmup = time.time() - t0
    print(f"# fd warmup {warmup:.1f}s", file=sys.stderr, flush=True)
    t0 = time.time()
    res = fd_obstacle_solve(n + 1, outer_tol=tol, device=dev)
    elapsed = time.time() - t0       # the result ends in a host copy
    return {"mode": "fd_stencil", "elapsed": elapsed, "n": n,
            "dofs": 2 * (n + 1) ** 2, "newton": res.newton_its,
            "outer": res.outer_iterations, "converged": True,
            "feasibility": float((res.u - res.phi).min()),
            "warmup_s": warmup}


def run_bench_stream(n_elems: int, device: str, esz: int = 4,
                     gb: tuple = (1.0, 0.6)) -> dict:
    """The reference bench's stream worker (bench.py _worker_stream) in
    torch: GB/s of a 3-stream axpy recurrence (read u, read v, write v'
    = (u + v) / 2, u' = v) from the slope of seconds against trip counts,
    with 1 chain (dep) and 4 independent chains (indep)."""
    import numpy as np
    import torch
    dev = torch.device(device)
    dt = torch.float32 if esz == 4 else torch.float64

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def probe(chains: int, gb_per_buf: float) -> float:
        rows = max(1, int(gb_per_buf * 1e9) // (n_elems * esz))
        size = rows * n_elems
        bufs = [[torch.full((size,), 1.0 + i, dtype=dt, device=dev),
                 torch.full((size,), 2.0 + i, dtype=dt, device=dev),
                 torch.empty(size, dtype=dt, device=dev)]
                for i in range(chains)]
        iter_bytes = 3 * size * esz * chains

        def timed(reps):
            best = float("inf")
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                for _ in range(reps):
                    for b in bufs:
                        torch.lerp(b[0], b[1], 0.5, out=b[2])
                        b[0], b[1], b[2] = b[1], b[2], b[0]
                sync()
                best = min(best, time.perf_counter() - t0)
            return best

        timed(2)                                   # warm
        counts = [10, 40, 160, 320] if chains == 1 else [5, 20, 60, 120]
        times = [timed(r) for r in counts]
        slope = float(np.polyfit(np.asarray(counts, float),
                                 np.asarray(times, float), 1)[0])
        gbps = iter_bytes / max(slope, 1e-12) / 1e9
        for r, t in zip(counts, times):
            print(f"# stream[{chains}ch] reps={r} t={t:.4f}s",
                  file=sys.stderr)
        print(f"# stream[{chains}ch] {chains} x {size} x {esz} B "
              f"({chains * size * esz / 1e9:.2f} GB a buffer set), slope "
              f"{slope * 1e3:.3f} ms/iter -> {gbps:.1f} GB/s",
              file=sys.stderr, flush=True)
        return gbps

    dep = probe(1, gb[0])
    indep = probe(4, gb[1])
    return {"stream_gbps": round(max(dep, indep), 1),
            "stream_gbps_dep": round(dep, 1),
            "stream_gbps_indep": round(indep, 1)}


# the distributed obstacle's Newton options by --pc: the reference CLI's
# Jacobi MINRES, and asm_btlu under GMRES(120) (parallel/dofpart.py
# _fused_options maps pc_type btlu to it)
DISTRIBUTED_DIRECTIONS = {
    "jacobi": {"ksp_type": "minres", "pc_type": "jacobi",
               "ksp_rtol": 1e-11, "ksp_max_it": 4000},
    "btlu": {"ksp_type": "preonly", "pc_type": "btlu",
             "pc_factor_dtype": "f64", "ksp_gmres_restart": 120,
             "ksp_rtol": 1e-11, "ksp_max_it": 600},
}


def _add_obstacle(sub):
    p = sub.add_parser("obstacle", help="Example 01: LVPP obstacle problem")
    p.add_argument("--polynomial_order", "-p", type=int, default=1,
                   choices=[1, 2])
    p.add_argument("--alpha-scheme", dest="alpha_scheme", default="constant",
                   choices=["constant", "double_exponential", "geometric"])
    p.add_argument("--max-iter", "-i", dest="max_iterations", type=int,
                   default=100)
    p.add_argument("--alpha-max", "-a", dest="alpha_max", type=float,
                   default=1e5)
    p.add_argument("--tol", "-t", dest="tol_exit", type=float, default=1e-6)
    p.add_argument("--disk-res", type=float, default=0.1,
                   help="disk mesh resolution (replaces --file-path)")
    p.add_argument("--rectangle", type=int, default=0, metavar="N",
                   help="solve on the N x N right-diagonal mesh of "
                        "[-1, 1]^2 in place of the disk (0 = the disk)")
    p.add_argument("--refinements", type=int, default=0)
    p.add_argument("--output-dir", type=Path, default=Path("output"))
    p.add_argument("--n-devices", dest="n_devices", type=int, default=0,
                   help="run the dof-partitioned distributed LVPP path over "
                        "this many subdomains, all on --device (0 = "
                        "single-device)")
    p.add_argument("--pc", choices=sorted(DISTRIBUTED_DIRECTIONS),
                   default="jacobi",
                   help="the distributed Newton direction (with "
                        "--n-devices): jacobi, MINRES with a Jacobi "
                        "preconditioner (default); btlu, restricted "
                        "additive Schwarz with a block-tridiagonal "
                        "subdomain factor under GMRES(120)")
    _add_device(p)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve, e.g. cuda or cpu "
                        "(default cuda)")


def _run_obstacle(args):
    from .io import write_vtu
    from .mesh import rectangle_mesh
    from .mesh.unstructured import create_disk_mesh, refine_uniform
    from .models.obstacle import solve_obstacle_problem
    mesh = (rectangle_mesh(args.rectangle, args.rectangle, p0=(-1.0, -1.0),
                           p1=(1.0, 1.0)) if args.rectangle
            else create_disk_mesh(args.disk_res))
    for _ in range(args.refinements):
        mesh = refine_uniform(mesh)
    if args.n_devices:
        _run_obstacle_distributed(args, mesh)
        return
    prob, result = solve_obstacle_problem(
        mesh, polynomial_order=args.polynomial_order,
        alpha_scheme=args.alpha_scheme,
        maximum_number_of_outer_loop_iterations=args.max_iterations,
        alpha_max=args.alpha_max, tol_exit=args.tol_exit,
        device=args.device)
    out = args.output_dir
    out.mkdir(parents=True, exist_ok=True)
    ndofs = prob.V.num_scalar_dofs
    result.to_csv(out / f"example_polyorder{args.polynomial_order}_"
                        f"{ndofs}.csv",
                  extra={"Polynomial order": args.polynomial_order,
                         "dofs": ndofs,
                         "Step size rule": args.alpha_scheme})
    if args.polynomial_order == 1:
        write_vtu(out / "u.vtu", mesh, point_data={"u": prob.u(result)})
    print(f"LVPP iterations: {result.iterations}  "
          f"Newton total: {result.total_newton}")


def _run_obstacle_distributed(args, mesh):
    """Obstacle LVPP on the dof-partitioned path over args.n_devices
    subdomains on --device, driven by the full LVPPSolver (the
    reference CLI's distributed obstacle, its options and printed line;
    the direction by --pc)."""
    import numpy as np
    from .models.obstacle import setup_obstacle_problem
    from .parallel.dofpart import DistributedLvppProblem, DistributedProblem
    from .solve.lvpp import AlphaScheduler, LVPPSolver

    prob = setup_obstacle_problem(mesh,
                                  polynomial_order=args.polynomial_order,
                                  verbose=False, device=args.device)
    p_ = prob.problem
    dp = DistributedProblem(p_, n_devices=args.n_devices)
    dlp = DistributedLvppProblem(dp)
    dlp.update(coeffs={"phi": dp.scatter_cellq(p_.coeffs["phi"])})
    result = LVPPSolver(
        dlp,
        newton_options={"snes_rtol": 1e-6, "snes_max_it": 50,
                        "snes_linesearch_type": "none",
                        **DISTRIBUTED_DIRECTIONS[args.pc]},
        alpha=AlphaScheduler(scheme=args.alpha_scheme
                             if args.alpha_scheme != "constant"
                             else "double_exponential",
                             alpha_max=args.alpha_max),
        prev_coeffs=lambda xs: {"psi_k": dp.field_to_coeff(xs, "psi"),
                                "u_k": dp.field_to_coeff(xs, "u")},
        tol=args.tol_exit, max_iterations=args.max_iterations,
    ).solve(dp.scatter(np.zeros(prob.space.num_dofs)))
    print(f"[distributed x{args.n_devices}] LVPP iterations: "
          f"{result.iterations}  Newton total: {result.total_newton}  "
          f"converged: {result.converged}  per-device dofs {dp.Bsum} "
          f"of {prob.space.num_dofs}")


def _add_models(sub):
    p = sub.add_parser("compare-all",
                       help="Example 01 five-solver comparison")
    p.add_argument("--disk-res", type=float, default=0.1)
    p.add_argument("--max-iter", type=int, default=500)
    p.add_argument("--tol", type=float, default=1e-4)
    _add_device(p)

    p = sub.add_parser("signorini", help="Example 02 Signorini contact")
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--disp", type=float, default=-0.10)
    p.add_argument("--res", type=float, default=0.04)
    p.add_argument("--E", type=float, default=2e4)
    p.add_argument("--nu", type=float, default=0.3)
    p.add_argument("--alpha_scheme", default="doubling",
                   choices=["constant", "linear", "doubling"])
    p.add_argument("--alpha_0", type=float, default=0.005)
    _add_device(p)

    p = sub.add_parser("obstacle-spectral",
                       help="Example 01 spectral variant")
    p.add_argument("--degrees", type=int, nargs="+",
                   default=[8, 16, 24, 32, 40, 48])
    p.add_argument("--solve-dtype", dest="solve_dtype", default="f64",
                   choices=("f64", "f32_refine"),
                   help="dense Newton factor precision: f32_refine factors "
                        "in float32 with three f64 refinement passes")
    _add_device(p)

    p = sub.add_parser("fracture", help="Example 03 phase-field fracture")
    p.add_argument("--res", type=float, default=0.05)
    p.add_argument("--Tmin", type=float, default=0.0)
    p.add_argument("--Tmax", type=float, default=5.0)
    p.add_argument("--num-load-steps", type=int, default=1001)
    p.add_argument("--n-devices", dest="n_devices", type=int, default=0,
                   help="run the load continuation dof-partitioned over "
                        "this many subdomains, all on --device (the "
                        "reference's mpirun execution of "
                        "fracture_dolfinx.py)")
    _add_device(p)

    p = sub.add_parser("multiphase", help="Example 04 Cahn-Hilliard")
    p.add_argument("-N", type=int, default=50)
    p.add_argument("-M", type=int, default=50)
    p.add_argument("--dt", dest="tau0", type=float, default=1e-5)
    p.add_argument("--T", type=float, default=7e-3)
    p.add_argument("--alpha_scheme", default="constant")
    p.add_argument("-s", "--stopping_tol", type=float, default=1e-5)
    _add_device(p)

    p = sub.add_parser("thermoforming", help="Example 05 QVI")
    p.add_argument("-M", type=int, default=150)
    p.add_argument("--compare", action="store_true",
                   help="also run MY / fixed-point / semismooth baselines")
    _add_device(p)

    p = sub.add_parser("gradient-constraint", help="Example 06")
    p.add_argument("-N", type=int, default=200)
    p.add_argument("-M", type=int, default=200)
    p.add_argument("--primal_degree", type=int, default=2)
    p.add_argument("--alpha_scheme", default="doubling")
    p.add_argument("--warm_start", action="store_true")
    p.add_argument("-s", "--stopping_tol", type=float, default=1e-8)
    _add_device(p)

    p = sub.add_parser("eigenvalue", help="Example 07 Landau-de Gennes")
    p.add_argument("-N", type=int, default=100)
    p.add_argument("--degree", type=int, default=3)
    _add_device(p)

    p = sub.add_parser("intersecting", help="Example 08")
    p.add_argument("--cells", type=int, default=1001)
    _add_device(p)

    p = sub.add_parser("eikonal", help="Example 09 Mobius eikonal")
    p.add_argument("--ns", type=int, default=48)
    p.add_argument("--nt", type=int, default=6)
    p.add_argument("--geometry", choices=["mobius", "star", "ball"],
                   default="mobius",
                   help="mobius = ex40 run of record; star / ball = the "
                        "ex40p planar-star and solid-ball variants")
    p.add_argument("--res", type=float, default=0.08,
                   help="star-mesh resolution")
    _add_device(p)

    p = sub.add_parser("monge-ampere", help="Example 10")
    p.add_argument("--kmin", type=int, default=3)
    p.add_argument("--kmax", type=int, default=14)
    _add_device(p)


def _coerce(v: str):
    """The reference CLI's coercion of an --opt value."""
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(v.lower(), v)


def _run_model(args, opts):
    dev = args.device
    if args.cmd == "obstacle-spectral":
        from .models.obstacle_spectral import spectral_p_sweep
        r = spectral_p_sweep(ps=tuple(args.degrees), verbose=True,
                             solve_dtype=args.solve_dtype, device=dev)
        print("degrees:", r.degrees)
        print("newton:", r.newton_its)
        print("sup diffs:", r.sup_errors)
    elif args.cmd == "compare-all":
        from .mesh.unstructured import create_disk_mesh
        from .models.obstacle_qp import compare_all
        compare_all(create_disk_mesh(args.disk_res), max_iter=args.max_iter,
                    tol=args.tol, device=dev)
    elif args.cmd == "signorini":
        from .models.signorini import solve_signorini
        r = solve_signorini(res=args.res, degree=args.degree, disp=args.disp,
                            E=args.E, nu=args.nu,
                            alpha_scheme=args.alpha_scheme,
                            alpha_0=args.alpha_0, solver_options=opts,
                            device=dev)
        print(f"LVPP {r.lvpp_iterations}, Newton {sum(r.newton_iterations)}, "
              f"final penetration {r.penetrations[-1]:.3e}")
    elif args.cmd == "fracture":
        from .models.fracture import solve_fracture
        r = solve_fracture(max_res=args.res, Tmin=args.Tmin, Tmax=args.Tmax,
                           num_load_steps=args.num_load_steps,
                           solver_options=opts, device=dev,
                           n_devices=args.n_devices or None)
        print(f"steps {len(r.load_history)} broken={r.broken}")
    elif args.cmd == "multiphase":
        from .models.multiphase import solve_multiphase
        r = solve_multiphase(N=args.N, M=args.M, tau0=args.tau0, T=args.T,
                             alpha_scheme=args.alpha_scheme,
                             stopping_tol=args.stopping_tol,
                             solver_options=opts, device=dev)
        print("Newton iterations:", r.newton_iterations)
        print("LVPP iterations:", r.lvpp_iterations)
    elif args.cmd == "thermoforming":
        from .models.thermoforming import solve_thermoforming
        r = solve_thermoforming(M=args.M, solver_options=opts, device=dev)
        print(f"Total LVPP {r.lvpp_iterations}, Newton {r.total_newton}")
        if args.compare:
            from .models.thermoforming_compare import (
                fixed_point_solve, moreau_yosida_solve,
                semismooth_active_set_solve)
            for name, fn in (("Moreau-Yosida", moreau_yosida_solve),
                             ("Fixed-point", fixed_point_solve),
                             ("Semismooth", semismooth_active_set_solve)):
                b = fn(M=args.M, verbose=False, device=dev)
                print(f"{name}: outer {b.outer_iterations}, "
                      f"linear solves {b.linear_solves}")
    elif args.cmd == "gradient-constraint":
        from .models.gradient_constraint import solve_gradient_constraint
        prob, r = solve_gradient_constraint(
            N=args.N, M=args.M, primal_degree=args.primal_degree,
            alpha_scheme=args.alpha_scheme, warm_start=args.warm_start,
            stopping_tol=args.stopping_tol, solver_options=opts, device=dev)
        print(f"Number of LVPP iterations {r.iterations}")
        print(f"Total number of Newton iterations: {r.total_newton}")
    elif args.cmd == "eigenvalue":
        from .models.eigenvalue_constraints import (
            solve_eigenvalue_constraints)
        r = solve_eigenvalue_constraints(N=args.N, degree=args.degree,
                                         solver_options=opts, device=dev)
        lo, hi = r.eigenvalue_range()
        print(f"#LVPP {r.lvpp.iterations} #Newton {r.lvpp.total_newton} "
              f"eig range [{lo:.4f}, {hi:.4f}]")
    elif args.cmd == "intersecting":
        from .models.intersecting import solve_intersecting
        r = solve_intersecting(n_cells=args.cells, device=dev)
        print(f"num_lvpp_iterations={r.lvpp_iterations}")
        print(f"num_newton_iterations={r.newton_iterations}")
    elif args.cmd == "eikonal":
        from .models.eikonal import solve_eikonal
        mesh = None
        if args.geometry == "star":
            from .mesh.unstructured import create_star_mesh
            mesh = create_star_mesh(args.res)
        elif args.geometry == "ball":
            from .mesh.parametric import create_ball_mesh
            mesh = create_ball_mesh(res=max(args.res, 0.15))
        r = solve_eikonal(mesh=mesh, ns=args.ns, nt=args.nt,
                          solver_options=opts, device=dev)
        print(f"LVPP {r.lvpp_iterations} Newton {r.total_newton}")
    elif args.cmd == "monge-ampere":
        from .models.monge_ampere import p_refinement_sweep
        r = p_refinement_sweep(args.kmin, args.kmax, device=dev)
        print("Errors", r.errors)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="proximalgalerkin_torch")
    parser.add_argument(
        "--opt", action="append", metavar="KEY=VALUE", default=[],
        help="solver option passthrough (PETSc-style names, e.g. "
             "--opt snes_linesearch_type=bt); repeatable, place before the "
             "subcommand")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_obstacle(sub)
    p = sub.add_parser("obstacle-fd", help="Example 01 FD variant")
    p.add_argument("-N", type=int, default=65)
    _add_device(p)
    _add_models(sub)
    p = sub.add_parser("bench", help="north-star obstacle benchmark")
    p.add_argument("-n", type=int, default=1024)
    _add_device(p)
    p.add_argument("--mode", choices=("fem", "fd", "stream"), default="fem",
                   help="the reference bench worker to run: fem (default), "
                        "fd or stream")
    p.add_argument("--esz", type=int, choices=(4, 8), default=4,
                   help="bytes an element of --mode stream (default 4)")
    p.add_argument("--pc", choices=("mg", "jacobi"), default="mg",
                   help="inner preconditioner: fused MG-PCG or fused "
                        "DIA-CG (default mg)")
    p.add_argument("--fused", action="store_true",
                   help="run solve_fused() (totals only) instead of solve()")
    args = parser.parse_args(argv)
    opts = {k: _coerce(v) for k, v in
            (kv.split("=", 1) for kv in args.opt)} or None
    if args.cmd == "obstacle":
        _run_obstacle(args)
    elif args.cmd == "obstacle-fd":
        from .models.obstacle_fd import fd_obstacle_solve
        r = fd_obstacle_solve(args.N, verbose=True, device=args.device)
        print(f"outer {r.outer_iterations} newton {r.newton_its}")
    elif args.cmd == "bench":
        if args.mode == "fd":
            out = run_bench_fd(args.n, args.device)
        elif args.mode == "stream":
            out = run_bench_stream((args.n + 1) ** 2, args.device, args.esz)
        else:
            out = run_bench(args.n, args.device, args.pc, args.fused)
        print(json.dumps(out), flush=True)
    else:
        _run_model(args, opts)


if __name__ == "__main__":
    main()
