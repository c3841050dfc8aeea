"""Damped Newton with SNES-compatible semantics.

Replaces PETSc SNES as driven by the reference (options at
obstacle_pg.py:128-139, fracture_dolfinx.py:163-180): linesearch
none/l2/bt, rtol/atol/stol convergence tests, SNES converged-reason codes,
and the `commit only on convergence` contract of `SNESSolver.solve`
(src/lvpp/problem.py:114-124) preserved by returning a result object the
caller commits explicitly.

This host-loop driver calls the problem's residual/Jacobian on the device
and supports pluggable linear solvers: host sparse LU ("preonly"+"lu", the
MUMPS stand-in: element matrices on the device, SuperLU on the host) or
device Krylov (cg/minres/gmres/bicgstab with Jacobi preconditioning, or
MINRES with the block-Schur preconditioners of la/schur.py). With
linesearch 'none' one Newton step reads the host once for its convergence
tests; `snes_fused` runs the whole Newton loop on the device
(solve/nonlinear.newton_loop) and reads it once a call, as the distributed
solver of parallel/dofpart.py, a NewtonSolver over the same loop, does.
pc_type='btlu' solves each Newton system with the device block-tridiagonal
factor of la/blocktri.py and f64 refinement (`_bt_direction`); with
`snes_fused` and `pc_factor_lag` the lagged factor rides the fused loop
(NonlinearProblem.fused_newton_btlu).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..core.config import SolverOptions
from ..core.logging import Monitor, PhaseTimer, count, rank_print, span
from ..core.reasons import ConvergedReason, NotConvergedError
from ..la.direct import LUFactorization
from .nonlinear import NonlinearProblem

# the options a device direction takes from the solver's options: the
# block-Schur preconditioner's interval and cycle knobs (la/schur.py) and
# the mixed-precision refinement budget
DIRECTION_OPTS = ("pc_schur_cheb_steps", "pc_schur_power_iters",
              "pc_schur_lmin_ratio", "pc_mg_nu", "ksp_refine_max")


@dataclass
class NewtonResult:
    x: torch.Tensor
    reason: ConvergedReason
    iterations: int
    fnorm: float
    fnorm_history: List[float] = field(default_factory=list)

    @property
    def converged(self) -> bool:
        return self.reason.converged


class NewtonSolver:
    def __init__(self, problem: NonlinearProblem,
                 options: Optional[SolverOptions] = None,
                 timer: Optional[PhaseTimer] = None):
        self.problem = problem
        self.options = options if isinstance(options, SolverOptions) \
            else SolverOptions(options or {})
        self.timer = timer or PhaseTimer(problem.device)
        # block-tridiagonal factorizations made (pc_type='btlu'), over
        # every solve of this solver
        self.refactors = 0

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        with self.timer.phase("host_transfer"):
            count("host_reads")
            return t.cpu().numpy()

    def _to_device(self, a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        with self.timer.phase("host_transfer"):
            return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    # ----------------------------------------------------------- linear

    def _solve_linear(self, x, F):
        """Solve J(x) dx = -F. Returns dx."""
        opts = self.options
        ksp = opts.opt("ksp_type")
        pc = opts.opt("pc_type")
        if pc == "btlu":
            with self.timer.phase("linear_solve_bt"):
                return self._bt_direction(x, F)
        if ksp == "preonly" or pc == "lu":
            lag = int(opts.opt("pc_factor_lag", 0) or 0)
            ordering = str(opts.opt("pc_factor_ordering", "auto"))
            with self.timer.phase("linear_solve_lu"):
                if not lag and ordering == "auto":
                    A = self.problem.jacobian_scipy(x, self.timer)
                    b = -self._to_host(F)
                    with self.timer.phase("lu_factor"):
                        lu = LUFactorization(A)
                    with self.timer.phase("lu_solve"):
                        dx = lu.solve(b)
                else:
                    dx = self._lu_direction(x, F, lag, ordering)
                return self._to_device(dx, F)
        pc_opts = {k: opts[k] for k in DIRECTION_OPTS if k in opts}
        step = self.problem.direction_solver(
            ksp, pc, str(opts.opt("mat_type", "ell")),
            schur_field0=opts.opt("pc_schur_field0", None),
            precision=str(opts.opt("ksp_precision", "double")),
            pc_opts=pc_opts)
        max_it_k = int(opts.opt("ksp_max_it"))
        rtol_k = float(opts.opt("ksp_rtol"))
        atol_k = float(opts.opt("ksp_atol"))
        # ksp_chunk_it: split one Krylov solve into several bounded
        # solves, each warm-started from the previous one
        chunk = int(opts.opt("ksp_chunk_it", 0) or 0)
        with self.timer.phase("linear_solve_krylov"):
            if not chunk or chunk >= max_it_k:
                return step(x, F, self.problem.coeffs, self.problem.consts,
                            rtol_k, atol_k, max_it_k)
            Av = self.problem.jacobian_action(x)
            count("host_reads")
            fnorm = float(torch.linalg.norm(F))
            monitor = bool(self.options.opt("ksp_monitor", False))
            import time as _time
            dx = None
            for ci in range(-(-max_it_k // chunk)):
                t0 = _time.time()
                dx = step(x, F, self.problem.coeffs, self.problem.consts,
                          rtol_k, atol_k, chunk, dx0=dx)
                count("host_reads")
                rres = float(torch.linalg.norm(Av(dx) + F))
                if monitor:
                    rank_print(f"      ksp chunk {ci}: relres "
                               f"{rres / max(fnorm, 1e-300):.3e} "
                               f"({_time.time() - t0:.1f}s)")
                if rres <= max(rtol_k * fnorm, atol_k) or not np.isfinite(
                        rres):
                    break
        return dx

    # --------------------------------------- device block-tridiagonal LU

    def _bt_direction(self, x, F):
        """Device-resident direct direction (pc_type='btlu'): line-ordered
        block-tridiagonal LDL on the device (la/blocktri.py), the
        lattice-problem MUMPS replacement. f32 (or f64) factor + f64
        iterative refinement against the assembled ELL operator; each
        refinement pass reads one norm from the host. Refactored every
        call unless pc_factor_lag keeps the factor across Newton steps and
        solves (then refactored only when refinement of the stale factor
        misses ksp tolerance)."""
        from ..la import blocktri as btm
        prob = self.problem
        opts = self.options
        blocking = prob.line_blocking()
        ell = prob.ell_matrix
        with self.timer.phase("bt_assemble"):
            data64 = prob.ell_data(x)
        # f64 factor for systems whose equilibrated conditioning defeats
        # the f32-factor + refinement scheme (multiphase saturated softmax)
        fdt = btm.factor_dtype(opts.opt("pc_factor_dtype", "f32"))
        Fact = btm.factorization(
            blocking, fdt, str(opts.opt("pc_factor_algo", "thomas")),
            bool(opts.opt("pc_factor_streamed", False)))
        adt = str(opts.opt("pc_factor_apply_dtype", fdt))
        biv = str(opts.opt("pc_factor_blockinv", "ns"))
        lag = int(opts.opt("pc_factor_lag", 0) or 0)
        b = -F
        count("host_reads")
        bnorm = float(torch.linalg.norm(b))
        tol = max(float(opts.opt("ksp_rtol")) * bnorm,
                  float(opts.opt("ksp_atol")))
        refine_max = int(opts.opt("pc_factor_refine_max", 20) or 20)
        monitor = bool(opts.opt("ksp_monitor", False))

        def refine(fact, fresh):
            """Refine fact.solve against the CURRENT operator; -> (dx, ok).
            A stale (lagged) factor is accepted only if refinement reaches
            ksp tolerance; a fresh one returns its best dx regardless
            (matching _lu_direction's lag contract)."""
            def on_pass(p, rn2):
                rank_print(f"      btlu[{'F' if fresh else 's'}] pass {p}: "
                           f"|r|/|b| {np.sqrt(rn2) / max(bnorm, 1e-300):.2e}")

            with self.timer.phase("bt_solve"):
                dx, reached, p = btm.refine(
                    fact.solve, lambda v: ell.spmv(data64, v), b, tol * tol,
                    refine_max, on_pass=on_pass if monitor else None)
            # the reference's host loop does not test the residual left by
            # its last allowed correction
            if fresh:
                return dx, True
            count("host_reads")
            if not bool(reached):
                return dx, False
            count("host_reads")
            return dx, int(p) < refine_max

        fact = getattr(self, "_lagged_bt", None) if lag else None
        if fact is not None:
            dx, ok = refine(fact, fresh=False)
            if ok:
                return dx
        with self.timer.phase("bt_factor"):
            fact = Fact(blocking, ell, data64, ell.arrays, dtype=fdt,
                        apply_dtype=adt, blockinv=biv)
        self.refactors += 1
        if lag:
            self._lagged_bt = fact
        dx, _ = refine(fact, fresh=True)
        return dx

    # ------------------------------------------------- lagged/ordered LU

    def _lu_direction(self, x, F, lag, ordering):
        """Host-LU direction with fill-reducing pre-ordering and
        factorization reuse (PETSc ``-snes_lag_jacobian`` /
        ``KSPSetReusePreconditioner`` analogue).

        ``ordering='nd'`` pre-permutes with geometric nested dissection
        (la/ordering.py) and an automatic within-node field rotation so
        static pivoting is safe on LVPP saddle blocks. ``lag != 0`` keeps
        the factorization across Newton iterations *and* solves; the
        stale factor is applied as a preconditioner for iterative
        refinement against the CURRENT matrix-free Jacobian action, so
        accepted directions satisfy ksp_rtol for the true Jacobian. A
        refactor is triggered only when refinement stops contracting."""
        prob = self.problem
        opts = self.options
        b = -self._to_host(F)
        bnorm = float(np.linalg.norm(b))
        tol = max(float(opts.opt("ksp_rtol")) * bnorm,
                  float(opts.opt("ksp_atol")))
        refine_max = int(opts.opt("pc_factor_refine_max", 20) or 20)
        Av = prob.jacobian_action(x)

        def apply(v):
            return self._to_host(Av(self._to_device(v, F)))

        def resid(dx):
            with self.timer.phase("lu_resid"):
                return b - apply(dx)

        monitor = bool(opts.opt("ksp_monitor", False))

        def refine(lu, fresh):
            """Richardson refinement while it contracts well; on slow
            contraction fall back to stale-LU-preconditioned GMRES.
            Refactor only if both fail."""
            with self.timer.phase("lu_apply"):
                dx = lu.solve(b)
            rn_prev = None
            for _p in range(refine_max):
                r = resid(dx)
                rn = float(np.linalg.norm(r))
                if monitor:
                    rank_print(f"      refine[{'F' if fresh else 's'}] "
                               f"pass {_p}: |r|/|b| {rn / bnorm:.2e}")
                if not np.isfinite(rn):
                    return dx, fresh
                if rn <= tol:
                    return dx, True
                if rn_prev is not None and rn > 0.5 * rn_prev and not fresh:
                    break
                rn_prev = rn
                with self.timer.phase("lu_apply"):
                    dx = dx + lu.solve(r)
            else:
                # refine_max exhausted while still contracting
                return dx, fresh
            # slow contraction / divergence: Krylov with stale-LU PC
            import scipy.sparse.linalg as _spla
            n = b.shape[0]
            op = _spla.LinearOperator((n, n), matvec=apply)
            M = _spla.LinearOperator((n, n), matvec=lu.solve)
            with self.timer.phase("lu_gmres"):
                dx, info = _spla.gmres(op, b, x0=dx, M=M, rtol=tol / bnorm,
                                       atol=0.5 * tol, restart=refine_max,
                                       maxiter=1)
            if info == 0:
                return dx, True
            rn = float(np.linalg.norm(resid(dx)))
            return dx, rn <= tol or fresh

        lu = getattr(self, "_lagged_lu", None)
        if lu is not None:
            dx, ok = refine(lu, fresh=False)
            if ok:
                return dx
        A = prob.jacobian_scipy(x, self.timer)
        factorizer = self._nd_factorizer(A, ordering)
        with self.timer.phase("lu_factor"):
            lu = LUFactorization(A) if factorizer is None \
                else factorizer.factor(A)
        if lag:
            self._lagged_lu = lu
        dx, _ = refine(lu, fresh=True)
        return dx

    def _nd_factorizer(self, A, ordering):
        """Cached PermutedFactorizer (ND permutations + data gather map)
        for this problem's pattern, or None for SuperLU's own ordering."""
        if ordering not in ("nd", "nd_sym"):
            return None
        if hasattr(self, "_nd_fact_cache"):
            return self._nd_fact_cache
        from ..la.direct import PermutedFactorizer
        from ..la.ordering import (best_field_rotation, block_permutations,
                                   coordinate_nd_order, node_adjacency)
        data = self.problem.nd_ordering_data()
        if data is None:
            self._nd_fact_cache = None
            return None
        dof_nodes, field_of, node_pts = data
        adj = node_adjacency(A, dof_nodes, node_pts.shape[0])
        node_order = coordinate_nd_order(adj, node_pts)
        rotation = None if ordering == "nd_sym" else \
            best_field_rotation(A, dof_nodes, field_of)
        perm_r, perm_c = block_permutations(dof_nodes, node_order,
                                            field_of, rotation)
        default_thresh = 0.0 if rotation is not None else 0.01
        thresh = float(self.options.opt("pc_factor_pivot_thresh",
                                        default_thresh))
        fdt = np.float32 if str(self.options.opt(
            "pc_factor_dtype", "f64")) in ("f32", "single") else np.float64
        self._nd_fact_cache = PermutedFactorizer(A, perm_r, perm_c, thresh,
                                                 dtype=fdt)
        return self._nd_fact_cache

    # -------------------------------------------------------- linesearch

    def _linesearch(self, x, dx, fnorm):
        """Returns new x (or None if the linesearch failed).

        PETSc-faithful implementations of the linesearch types the
        reference configures (obstacle_pg.py:136 'none',
        fracture_dolfinx.py:163-180 l2/bt semantics):
          l2: secant/Newton minimization of ||F(x+t dx)||^2 from a
              quadratic fit through t=0, t/2, t (linesearchl2.c 3-point
              one-sided difference formulas), snes_linesearch_max_it
              fits (PETSc default 1); accepts the minimizer.
          bt: Armijo on g(t)=0.5||F||^2 with quadratic first backtrack
              and cubic continuation (linesearchbt.c), initslope from an
              actual Jacobian action <J dx, F>.
        """
        ls = self.options.opt("snes_linesearch_type")
        damping = float(self.options.opt("snes_linesearch_damping"))
        prob = self.problem

        def fsq(t):
            r = prob.residual(x + t * dx)
            count("host_reads")
            v = float(torch.dot(r, r))
            return v if np.isfinite(v) else np.inf

        if ls == "none":
            return x + damping * dx
        if ls == "l2":
            max_it = int(self.options.opt("snes_linesearch_max_it", 1))
            lam, lam_old = damping, 0.0
            fnrm_old = fnorm * fnorm
            fnrm = None
            for _ in range(max_it):
                dlam = lam - lam_old
                fnrm_mid = fsq(lam_old + 0.5 * dlam)
                fnrm = fsq(lam)
                # one-sided 3-point formulas at t=lam (h = dlam/2)
                dF = (3.0 * fnrm - 4.0 * fnrm_mid + fnrm_old) / dlam
                d2F = 4.0 * (fnrm - 2.0 * fnrm_mid + fnrm_old) / dlam**2
                if not (np.isfinite(dF) and np.isfinite(d2F)) or d2F == 0.0:
                    lam_t = 0.5 * lam
                else:
                    lam_t = lam - dF / d2F
                lam_old, fnrm_old = lam, fnrm
                if lam_t <= 0.0 or not np.isfinite(lam_t):
                    lam_t = 0.5 * lam
                lam = lam_t
            xt = x + lam * dx
            fn = fsq(lam)
            if not np.isfinite(fn):
                return None
            return xt
        if ls == "bt":
            alpha = float(self.options.opt("snes_linesearch_alpha", 1e-4))
            max_its = int(self.options.opt("snes_linesearch_max_it", 40))
            g0 = 0.5 * fnorm * fnorm
            # initslope = <J dx, F> (linesearchbt.c computes the true
            # directional derivative; = -||F||^2 only for exact solves)
            Jdx = self.problem.jacobian_action(x)(dx)
            count("host_reads")
            initslope = float(torch.dot(Jdx, prob.residual(x)))
            if not np.isfinite(initslope) or initslope >= 0.0:
                initslope = -fnorm * fnorm
            lam = damping
            g_lam = 0.5 * fsq(lam)
            if g_lam <= g0 + alpha * lam * initslope:
                return x + lam * dx
            # quadratic first backtrack
            lam_prev, g_prev = lam, g_lam
            denom = 2.0 * (g_lam - g0 - lam * initslope)
            lam_t = -initslope * lam**2 / denom if denom != 0.0 else 0.5 * lam
            lam = min(max(lam_t, 0.1 * lam), 0.5 * lam)
            minlambda = damping * 1e-12
            for _ in range(max_its):
                if lam < minlambda:
                    return None
                g_lam = 0.5 * fsq(lam)
                if g_lam <= g0 + alpha * lam * initslope:
                    return x + lam * dx
                # cubic interpolation through (lam, g_lam), (lam_prev, g_prev)
                t1 = g_lam - g0 - lam * initslope
                t2 = g_prev - g0 - lam_prev * initslope
                dl = lam - lam_prev
                if dl == 0.0:
                    lam_t = 0.5 * lam
                else:
                    a = (t1 / lam**2 - t2 / lam_prev**2) / dl
                    bq = (-lam_prev * t1 / lam**2
                          + lam * t2 / lam_prev**2) / dl
                    if a == 0.0:
                        lam_t = -initslope / (2.0 * bq) if bq != 0.0 \
                            else 0.5 * lam
                    else:
                        disc = bq * bq - 3.0 * a * initslope
                        if disc < 0.0:
                            lam_t = 0.5 * lam
                        elif bq <= 0.0:
                            lam_t = (-bq + np.sqrt(disc)) / (3.0 * a)
                        else:
                            lam_t = -initslope / (bq + np.sqrt(disc))
                lam_prev, g_prev = lam, g_lam
                lam = min(max(lam_t, 0.1 * lam), 0.5 * lam)
            return None
        raise ValueError(f"unknown linesearch {ls!r}")

    # ------------------------------------------------------------- solve

    def _reason(self, ls_ok, fn, f0, sconv) -> ConvergedReason:
        opts = self.options
        if not ls_ok:
            return ConvergedReason.DIVERGED_LINE_SEARCH
        if not np.isfinite(fn):
            return ConvergedReason.DIVERGED_FNORM_NAN
        if fn < float(opts.opt("snes_atol")):
            return ConvergedReason.CONVERGED_FNORM_ABS
        if fn <= float(opts.opt("snes_rtol")) * f0:
            return ConvergedReason.CONVERGED_FNORM_RELATIVE
        if sconv:
            return ConvergedReason.CONVERGED_SNORM_RELATIVE
        return ConvergedReason.DIVERGED_MAX_IT

    def _finish(self, reason: ConvergedReason, it: int):
        opts = self.options
        if opts.opt("snes_converged_reason"):
            rank_print(f"Nonlinear solve converged due to {reason.name} "
                       f"iterations {it}" if reason.converged else
                       f"Nonlinear solve did not converge due to "
                       f"{reason.name} iterations {it}")
        if (not reason.converged) and opts.opt("snes_error_if_not_converged"):
            raise NotConvergedError(reason)

    # the phase that times a fused solve, its read included
    FUSED_PHASE = "newton_fused"

    def _fused_call(self):
        """(fused, kw, it_per_call): the device Newton loop these options
        select, the keywords of a call beside x0, coeffs, consts, rtol,
        atol and it_cap, and the Newton iterations one call may take."""
        opts = self.options
        prob = self.problem
        pc_opts = {k: opts[k] for k in (*DIRECTION_OPTS,
                                        "pc_factor_streamed",
                                        "pc_factor_dtype",
                                        "pc_factor_apply_dtype",
                                        "pc_factor_algo") if k in opts}
        max_it = int(opts.opt("snes_max_it"))
        # snes_fused_chunk bounds one fused call to `chunk` Newton
        # iterations; the host warm-restarts chunks from the returned
        # iterate, and the lagged-btlu factor persists across chunks on
        # the fused function
        chunk = int(opts.opt("snes_fused_chunk", 0) or 0)
        it_per_call = chunk if 0 < chunk < max_it else max_it
        kw = dict(stol=float(opts.opt("snes_stol")),
                  ksp_rtol=float(opts.opt("ksp_rtol")),
                  ksp_atol=float(opts.opt("ksp_atol")),
                  damping=float(opts.opt("snes_linesearch_damping")))
        if opts.opt("pc_type") == "btlu" and opts.opt("pc_factor_lag", 0):
            fused = prob.fused_newton_btlu(
                linesearch=opts.opt("snes_linesearch_type"),
                max_it=it_per_call, pc_opts=pc_opts)
            kw["timer"] = self.timer
        else:
            fused = prob.fused_newton(
                opts.opt("ksp_type"), opts.opt("pc_type"),
                str(opts.opt("mat_type", "ell")),
                linesearch=opts.opt("snes_linesearch_type"),
                max_it=it_per_call,
                ksp_max_it=int(opts.opt("ksp_max_it")),
                schur_field0=opts.opt("pc_schur_field0", None),
                pc_opts=pc_opts)
        return fused, kw, it_per_call

    def _tally(self, fused):
        """Book what a fused call reports beside its result."""
        self.refactors += getattr(fused, "last_refactors", 0)

    def _solve_fused(self, x0) -> NewtonResult:
        """Whole-solve path: the device Newton loop of _fused_call; the
        SNES reason is reconstructed from one host read per call."""
        opts = self.options
        prob = self.problem
        fused, kw, it_per_call = self._fused_call()
        max_it = int(opts.opt("snes_max_it"))
        rtol_o = float(opts.opt("snes_rtol"))
        atol_o = float(opts.opt("snes_atol"))

        def read(*ts):
            # one batched read of the scalars of a call
            count("host_reads")
            return torch.stack([t.to(torch.float64) for t in ts]).tolist()

        with self.timer.phase(self.FUSED_PHASE):
            x, it, fn, f0, ls_ok, sconv = fused(
                x0, prob.coeffs, prob.consts, rtol=rtol_o, atol=atol_o,
                **kw)
            it, fn, f0, ls_ok, sconv = read(it, fn, f0, ls_ok, sconv)
            it = int(it)
            self._tally(fused)
            if it_per_call < max_it:
                # continuation chunks test against the FIRST chunk's f0
                atol_eff = max(atol_o, rtol_o * f0)
                while (it_per_call <= it < max_it and bool(ls_ok)
                       and not bool(sconv) and np.isfinite(fn)
                       and fn > atol_eff):
                    budget = min(it_per_call, max_it - it)
                    x, itc, fn, _, ls_ok, sconv = fused(
                        x, prob.coeffs, prob.consts, rtol=0.0,
                        atol=atol_eff, it_cap=budget, **kw)
                    itc, fn, ls_ok, sconv = read(itc, fn, ls_ok, sconv)
                    it += int(itc)
                    self._tally(fused)
                    if int(itc) < budget:
                        break
        reason = self._reason(bool(ls_ok), fn, f0, bool(sconv))
        self._finish(reason, it)
        return NewtonResult(x, reason, it, fn, [f0, fn])

    def solve(self, x0) -> NewtonResult:
        """One Newton solve from x0, inside the span `newton.solve`."""
        with span("newton.solve"):
            if self.options.opt("snes_fused"):
                return self._solve_fused(x0)
            return self._solve_steps(x0)

    def _solve_steps(self, x0) -> NewtonResult:
        opts = self.options
        prob = self.problem
        rtol = float(opts.opt("snes_rtol"))
        atol = float(opts.opt("snes_atol"))
        stol = float(opts.opt("snes_stol"))
        max_it = int(opts.opt("snes_max_it"))
        ls_none = opts.opt("snes_linesearch_type") == "none"
        damping = float(opts.opt("snes_linesearch_damping"))
        monitor = Monitor("SNES Function", enabled=bool(opts.opt("snes_monitor")))

        x = prob.set_bc(x0)
        with self.timer.phase("residual"):
            F = prob.residual(x)
        count("host_reads")
        fnorm = float(torch.linalg.norm(F))
        f0 = fnorm
        monitor(0, fnorm)
        history = [fnorm]
        reason = ConvergedReason.ITERATING
        it = 0

        if not np.isfinite(fnorm):
            return NewtonResult(x, ConvergedReason.DIVERGED_FNORM_NAN, 0,
                                fnorm, history)
        if fnorm < atol:
            return NewtonResult(x, ConvergedReason.CONVERGED_FNORM_ABS, 0,
                                fnorm, history)

        while it < max_it:
            dx = self._solve_linear(x, F)
            finite = torch.all(torch.isfinite(dx))
            if ls_none:
                # the step, its residual and the norms of the convergence
                # tests come back in one read
                with self.timer.phase("linesearch"):
                    x_new = x + damping * dx
                with self.timer.phase("residual"):
                    F_new = prob.residual(x_new)
                count("host_reads")
                ok, fnorm_new, snorm, xnorm = torch.stack([
                    finite.to(F.dtype), torch.linalg.norm(F_new),
                    torch.linalg.norm(dx), torch.linalg.norm(x_new)]).tolist()
                if not ok:
                    reason = ConvergedReason.DIVERGED_LINEAR_SOLVE
                    break
            else:
                count("host_reads")
                if not bool(finite):
                    reason = ConvergedReason.DIVERGED_LINEAR_SOLVE
                    break
                with self.timer.phase("linesearch"):
                    x_new = self._linesearch(x, dx, fnorm)
                if x_new is None:
                    reason = ConvergedReason.DIVERGED_LINE_SEARCH
                    break
                with self.timer.phase("residual"):
                    F_new = prob.residual(x_new)
                count("host_reads")
                fnorm_new, snorm, xnorm = torch.stack([
                    torch.linalg.norm(F_new), torch.linalg.norm(dx),
                    torch.linalg.norm(x_new)]).tolist()
            it += 1
            x, F, fnorm = x_new, F_new, fnorm_new
            monitor(it, fnorm)
            history.append(fnorm)
            if not np.isfinite(fnorm):
                reason = ConvergedReason.DIVERGED_FNORM_NAN
                break
            if fnorm < atol:
                reason = ConvergedReason.CONVERGED_FNORM_ABS
                break
            if fnorm <= rtol * f0:
                reason = ConvergedReason.CONVERGED_FNORM_RELATIVE
                break
            if snorm < stol * max(xnorm, 1e-300):
                reason = ConvergedReason.CONVERGED_SNORM_RELATIVE
                break
        else:
            reason = ConvergedReason.DIVERGED_MAX_IT
        if reason == ConvergedReason.ITERATING:
            reason = ConvergedReason.DIVERGED_MAX_IT

        self._finish(reason, it)
        return NewtonResult(x, reason, it, fnorm, history)


class SNESSolver:
    """API-compatible analogue of `lvpp.SNESSolver` (problem.py:80-124):
    holds a mutable state vector, solves, and commits only on convergence."""

    def __init__(self, problem: NonlinearProblem, options=None):
        self.problem = problem
        self.newton = NewtonSolver(problem, options)
        self.u = problem.set_bc(torch.zeros(problem.space.num_dofs,
                                            dtype=problem.form.dtype,
                                            device=problem.device))

    def solve(self):
        res = self.newton.solve(self.u)
        if res.converged:
            self.u = res.x
        return int(res.reason), res.iterations
