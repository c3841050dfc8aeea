"""The JAX package's CPU runs whose counts chip_smoke.py's phases 12 and 13
pin (eikonal, Monge–Ampère, the gradient constraint with schur_mg;
Signorini and the five-solver comparison).

    python scripts/jax_reference_records.py CASE

prints one JSON line: the case's counts, observables and seconds. CASE is
one of CASES below; gcmg_N is the N^2 P2 gradient constraint with minres
/ schur_mg / mixed / block0 psi (verbose, with the Newton reasons on
stderr); dir_N the relative residual |J dx + F| / |F| of that problem's
first Newton direction (alpha = 1, x0 = 0), and dir0_N the same with no
f64 refinement pass (ksp_refine_max 0: the f32 inner solve alone);
sig2d_D the Signorini half-disk at res 0.04 pressed by disp = -D (D one of
0.10, 0.15, 0.20), sig3d the half-sphere at res 0.12, sig3d_006 the
half-sphere at res 0.06 cut to its first 5 LVPP steps, compare_all
the five solvers on the disk at res 0.1, tol 1e-4 (RESULTS.md:160-162),
and halo_N the halo-exchange FD obstacle fd_obstacle_solve_sharded(N) on
8 virtual devices (phase 14). It runs the JAX package on the CPU, as the
repository's tests do.
"""

import json
import os
import sys
import time

os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count="
    + ("8" if sys.argv[1:2] and sys.argv[1].startswith("halo_") else "1"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

SCHUR_MINRES = {"ksp_type": "minres", "ksp_rtol": 1e-10, "ksp_atol": 1e-12,
                "ksp_max_it": 3000}
MATFREE = {"ksp_type": "minres", "pc_type": "jacobi", "mat_type": "matfree",
           "ksp_rtol": 1e-9, "ksp_max_it": 4000, "snes_rtol": 1e-8,
           "snes_max_it": 50}
CASES = ("eik_lu", "eik_schur", "eik_matfree", "eik_star", "ball_0.45",
         "ball_0.3", "ball_0.15", "ma", "ma_h", "gcmg_16", "gcmg_24",
         "gcmg_48", "dir_N", "dir0_N", "sig2d_0.10", "sig2d_0.15",
         "sig2d_0.20", "sig3d", "sig3d_006", "compare_all", "halo_N")


def eikonal(r):
    return {"lvpp": r.lvpp_iterations, "newton": r.newton_iterations,
            "converged": r.converged, "umax": float(np.max(r.u)),
            "umin": float(np.min(r.u))}


def run(case: str) -> dict:
    from proximalgalerkin_tpu.models.eikonal import solve_eikonal
    if case == "eik_lu":
        return eikonal(solve_eikonal(ns=48, nt=6, verbose=False))
    if case == "eik_schur":
        return eikonal(solve_eikonal(ns=48, nt=6, verbose=False,
                                     solver_options=SCHUR_MINRES))
    if case == "eik_matfree":
        lu = solve_eikonal(ns=24, nt=4, verbose=False)
        r = solve_eikonal(ns=24, nt=4, verbose=False, solver_options=MATFREE)
        return {**eikonal(r), "lu": eikonal(lu),
                "max_du_lu": float(np.abs(np.asarray(r.u)
                                          - np.asarray(lu.u)).max())}
    if case == "eik_star":
        from proximalgalerkin_tpu.mesh.unstructured import create_star_mesh
        return eikonal(solve_eikonal(mesh=create_star_mesh(0.08),
                                     verbose=False))
    if case.startswith("ball_"):
        from proximalgalerkin_tpu.mesh.parametric import create_ball_mesh
        return eikonal(solve_eikonal(
            mesh=create_ball_mesh(res=float(case.split("_")[1])),
            verbose=True))
    if case in ("ma", "ma_h"):
        from proximalgalerkin_tpu.models import monge_ampere as ma
        s = (ma.p_refinement_sweep(3, 8, verbose=False) if case == "ma"
             else ma.h_refinement_sweep(3, 4, verbose=False))
        return {"errors": s.errors, "newton": s.newton_its, "dofs": s.dofs}
    if case.startswith("gcmg_"):
        from proximalgalerkin_tpu.models.gradient_constraint import \
            solve_gradient_constraint
        n = int(case.split("_")[1])
        _, r = solve_gradient_constraint(
            N=n, M=n, primal_degree=2, alpha_scheme="doubling",
            stopping_tol=1e-8, verbose=True,
            solver_options={"ksp_type": "minres", "pc_type": "schur_mg",
                            "ksp_precision": "mixed",
                            "pc_schur_field0": "psi",
                            "snes_converged_reason": True})
        return {"lvpp": r.iterations, "newton": r.newton_steps,
                "converged": r.converged}
    if case.startswith(("dir_", "dir0_")):
        import jax.numpy as jnp
        from proximalgalerkin_tpu.models.gradient_constraint import \
            setup_gradient_constraint
        n = int(case.split("_")[1])
        prob = setup_gradient_constraint(N=n, M=n, primal_degree=2,
                                         stopping_tol=1e-8, verbose=False)
        p = prob.solver.newton.problem
        x0 = jnp.asarray(prob.x0)
        p.update(coeffs=prob.solver.prev_coeffs(x0),
                 consts={"alpha": jnp.asarray(1.0)})
        x = jnp.asarray(p.set_bc(x0))
        F = p.residual(x)
        dx = p.direction_solver(
            "minres", "schur_mg", schur_field0="psi", precision="mixed",
            pc_opts={"ksp_refine_max": 0} if case.startswith("dir0_")
            else None)(
            x, F, p.coeffs, p.consts, 1e-10, 1e-50, 10_000)
        r = p.jacobian_scipy(x) @ np.asarray(dx) + np.asarray(F)
        return {"relative_residual": float(np.linalg.norm(r)
                                           / np.linalg.norm(F))}
    if case.startswith("sig"):
        from proximalgalerkin_tpu.mesh.parametric import create_half_sphere
        from proximalgalerkin_tpu.models.signorini import solve_signorini
        if case.startswith("sig2d_"):
            r = solve_signorini(res=0.04, disp=-float(case.split("_")[1]),
                                verbose=True)
        elif case == "sig3d":
            r = solve_signorini(tagged=create_half_sphere(res=0.12),
                                verbose=True)
        else:
            r = solve_signorini(tagged=create_half_sphere(res=0.06),
                                max_iterations=5, verbose=True)
        return {"lvpp": r.lvpp_iterations, "newton": r.newton_iterations,
                "converged": r.converged, "penetrations": r.penetrations,
                "psi_min": float(np.min(r.psi)), "dofs": int(
                    r.u.size + np.asarray(r.psi).size)}
    if case == "compare_all":
        from proximalgalerkin_tpu.mesh.unstructured import create_disk_mesh
        from proximalgalerkin_tpu.models.obstacle_qp import compare_all
        r = compare_all(create_disk_mesh(0.1), max_iter=500, tol=1e-4,
                        verbose=False)
        ref = np.asarray(r.solutions["SNES-VI"])
        return {"iterations": r.iterations,
                "max_diff_to_vi": {k: float(np.abs(np.asarray(v) - ref).max())
                                   for k, v in r.solutions.items()
                                   if np.shape(v) == ref.shape}}
    if case.startswith("halo_"):
        from proximalgalerkin_tpu.parallel.halo import \
            fd_obstacle_solve_sharded
        assert len(jax.devices()) == 8
        u, phi, outer, newton = fd_obstacle_solve_sharded(
            int(case.split("_")[1]))
        u = np.asarray(u)
        return {"outer": outer, "newton": newton,
                "min_u_minus_phi": float(np.min(u - phi)),
                "umax": float(u.max())}
    raise SystemExit(f"unknown case {case!r}; one of {CASES}")


if __name__ == "__main__":
    t0 = time.perf_counter()
    out = {"case": sys.argv[1], **run(sys.argv[1])}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
