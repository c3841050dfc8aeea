"""Nonlinear problem: couples a VolumeForm with Dirichlet BCs into the
residual/Jacobian operators the Newton solver consumes.

Mirrors the role of `lvpp.SNESProblem` (reference src/lvpp/problem.py:14-77):
BC-consistent residual (F[bc] = x[bc] - g, zero once x satisfies the BC) and
symmetric BC treatment of the Jacobian (zeroed bc rows/columns, identity on
the bc diagonal) — for both the matrix-free action and assembled matrices.

Device-resident Newton directions (`direction_solver`) and the whole-solve
Newton loops run their iterations as la/loop.while_loop: the Krylov loops
read the host once per chunk of about 64 iterations, a refinement pass or
a Newton step once each. `newton_loop` is the one device Newton loop;
`fused_newton`, `fused_newton_btlu` and parallel/dofpart's
`fused_lvpp_newton` give it their direction and line search.

The block-tridiagonal direct direction pc='btlu' (la/blocktri.py) runs in
both: refactored every Newton step in `fused_newton`, and lagged across
Newton steps and solves in `fused_newton_btlu`, which assembles the
Jacobian from an `EllSplit` where a model installs one (multiphase).

The block-Schur preconditioners pc='schur' (Chebyshev S-solve) and
pc='schur_mg' (lattice V-cycle S-solve) of la/schur.py run under MINRES
on the equilibrated ELL system, in double or precision='mixed' (an f32
inner MINRES inside f64 iterative refinement).
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch.func import jvp

from ..assembly.assemble import VolumeForm
from ..core.logging import count
from ..la.loop import while_loop
from ..spaces.space import DirichletBC

f32 = torch.float32


def _refined(solve_lo, Av, b, rtol, atol, max_passes, dx0=None):
    """f64 iterative refinement around a lower-precision inner solver.

    solve_lo(r64) must return an approximate f64 solution of A z = r64
    (typically: equilibrate, solve in f32 to ~1e-6, unscale). Passes repeat
    while the TRUE f64 residual ||b - A dx|| still exceeds
    max(rtol*||b||, atol) AND keeps improving by >=10%. Non-improving
    corrections are rejected so the best iterate is always returned.
    Each pass is a whole inner Krylov solve, so the loop reads its
    condition once per pass (chunk 1)."""
    bnorm = torch.linalg.norm(b)
    target = torch.clamp(rtol * bnorm, min=atol)
    dx = solve_lo(b) if dx0 is None else dx0
    r = b - Av(dx)
    rn = torch.linalg.norm(r)
    big = torch.tensor(torch.finfo(b.dtype).max, dtype=b.dtype,
                       device=b.device)
    i0 = torch.zeros((), dtype=torch.int64, device=b.device)

    def cond(state):
        i, dx, r, rn, rn_prev = state
        return ((i < max_passes) & (rn > target) & (rn < 0.9 * rn_prev)
                & torch.isfinite(rn))

    def body(state):
        i, dx, r, rn, _ = state
        dxn = dx + solve_lo(r)
        rv = b - Av(dxn)
        rnn = torch.linalg.norm(rv)
        better = rnn < rn
        return (i + 1, torch.where(better, dxn, dx),
                torch.where(better, rv, r), torch.minimum(rnn, rn), rn)

    return while_loop(cond, body, (i0, dx, r, rn, big), chunk=1)[1]


def _fused_linesearch(linesearch, residual, fsq, x, dx, fnorm, damping):
    """Device linesearch shared by the fused Newton solver -> (x_new, ok)
    (ok a 0-dim bool tensor). Twins of NewtonSolver._linesearch's types:
    'none' (damped), 'l2' (one secant/quadratic fit), 'bt' (Armijo on
    0.5||F||^2 with a quadratic first backtrack and cubic backtracks with
    lambda clamped to [0.1, 0.5]*lambda, and the TRUE initslope <J dx, F>;
    PETSc linesearchbt.c)."""
    true = torch.ones((), dtype=torch.bool, device=x.device)
    if linesearch == "none":
        return x + damping * dx, true
    if linesearch == "l2":
        lam = damping
        f_old = fnorm * fnorm
        f_mid = fsq(x + 0.5 * lam * dx)
        f_new = fsq(x + lam * dx)
        dF = (3.0 * f_new - 4.0 * f_mid + f_old) / lam
        d2F = 4.0 * (f_new - 2.0 * f_mid + f_old) / lam ** 2
        lam_t = torch.where(torch.abs(d2F) > 1e-300, lam - dF / d2F,
                            0.5 * lam)
        lam_t = torch.where(torch.isfinite(lam_t) & (lam_t > 0.0), lam_t,
                            0.5 * lam)
        xn = x + lam_t * dx
        return xn, torch.isfinite(fsq(xn))
    if linesearch == "bt":
        alpha = 1e-4
        max_its = 40
        g0 = 0.5 * fnorm * fnorm
        F0 = residual(x)
        Jdx = jvp(residual, (x,), (dx,))[1]
        islope = torch.dot(Jdx, F0)
        islope = torch.where(torch.isfinite(islope) & (islope < 0.0),
                             islope, -fnorm * fnorm)
        lam0 = torch.as_tensor(damping, dtype=x.dtype, device=x.device)
        g_full = 0.5 * fsq(x + lam0 * dx)
        ok_full = torch.isfinite(g_full) & (g_full <= g0 + alpha * lam0
                                            * islope)
        # quadratic first backtrack
        denom = 2.0 * (g_full - g0 - lam0 * islope)
        lam_q = torch.where(denom != 0.0, -islope * lam0 * lam0 / denom,
                            0.5 * lam0)
        lam1 = torch.minimum(torch.maximum(lam_q, 0.1 * lam0), 0.5 * lam0)
        minlambda = damping * 1e-12

        def cond(s):
            i, lam, lam_prev, g_prev, ok, fail = s
            return (i < max_its) & ~(ok | fail)

        def body(s):
            i, lam, lam_prev, g_prev, _, _ = s
            fail = lam < minlambda
            g_lam = 0.5 * fsq(x + lam * dx)
            ok = torch.isfinite(g_lam) & (g_lam <= g0 + alpha * lam * islope)
            # cubic interpolation through (lam, g_lam), (lam_prev, g_prev)
            t1 = g_lam - g0 - lam * islope
            t2 = g_prev - g0 - lam_prev * islope
            dl = lam - lam_prev
            safe_dl = torch.where(dl == 0.0, 1.0, dl)
            a = (t1 / (lam * lam) - t2 / (lam_prev * lam_prev)) / safe_dl
            bq = (-lam_prev * t1 / (lam * lam)
                  + lam * t2 / (lam_prev * lam_prev)) / safe_dl
            disc = bq * bq - 3.0 * a * islope
            lam_cub = torch.where(
                a == 0.0,
                torch.where(bq != 0.0, -islope / (2.0 * bq), 0.5 * lam),
                torch.where(disc < 0.0, 0.5 * lam,
                            torch.where(bq <= 0.0,
                                        (-bq + torch.sqrt(torch.abs(disc)))
                                        / (3.0 * torch.where(a == 0.0, 1.0,
                                                             a)),
                                        -islope / (bq + torch.sqrt(
                                            torch.abs(disc))))))
            lam_t = torch.where(dl == 0.0, 0.5 * lam, lam_cub)
            lam_n = torch.minimum(torch.maximum(lam_t, 0.1 * lam), 0.5 * lam)
            keep = ok | fail
            return (i + 1, torch.where(keep, lam, lam_n),
                    torch.where(keep, lam_prev, lam),
                    torch.where(keep, g_prev, g_lam), ok, fail)

        i0 = torch.zeros((), dtype=torch.int64, device=x.device)
        # chunk 1: each backtrack is a residual evaluation, and most line
        # searches accept the full step, so a masked chunk would cost up
        # to 64 residuals where the loop needs none or a few
        _, lam, _, _, ok, _ = while_loop(
            cond, body, (i0, lam1, lam0, g_full, ok_full, ~true), chunk=1)
        lam = torch.where(ok_full, lam0, lam)
        return x + lam * dx, ok
    raise ValueError(f"unknown fused linesearch {linesearch!r}")


def newton_loop(residual, norm, direction, linesearch, x, rtol, atol, stol,
                cap, update_phase=contextlib.nullcontext):
    """The device Newton loop of every fused solver, from x with its
    Dirichlet values set: dx = direction(x, F); then, inside
    update_phase(), (x_new, ls_ok) = linesearch(x, dx, fnorm), the SNES
    stol test ||x_new - x|| < stol ||x_new|| (where stol > 0) and the new
    residual. It runs while fnorm > max(rtol f0, atol) is finite, ls_ok
    and not the stol test, for at most cap steps, one host read a step
    (chunk 1: a masked step would still solve); `norm` is the serial or
    the shard axis's 2-norm. -> (x, it, fnorm, f0, ls_ok, sconv) on the
    device, from which NewtonSolver._reason rebuilds the SNES reason."""
    dev = x.device
    F = residual(x)
    f0 = norm(F)
    stop = torch.clamp(rtol * f0, min=atol)
    false = torch.zeros((), dtype=torch.bool, device=dev)

    def cond(s):
        it, x, F, fnorm, ls_ok, sconv = s
        return ((fnorm > stop) & torch.isfinite(fnorm) & ~sconv
                & (it < cap) & ls_ok)

    def body(s):
        it, x, F, fnorm, _, _ = s
        dx = direction(x, F)
        with update_phase():
            xn, ls_ok = linesearch(x, dx, fnorm)
            sconv = false
            if stol > 0:
                sconv = norm(xn - x) < stol * torch.clamp(norm(xn),
                                                          min=1e-300)
            F = residual(xn)
        return it + 1, xn, F, norm(F), ls_ok, sconv

    state = (torch.zeros((), dtype=torch.int64, device=dev), x, F, f0,
             ~false, false)
    it, x, F, fnorm, ls_ok, sconv = while_loop(cond, body, state, chunk=1)
    return x, it, fnorm, f0, ls_ok, sconv


class EllSplit:
    """Affine/nonlinear Jacobian split for the fused device Newton — the
    device twin of csr_data_override (see jacobian_scipy below): models
    whose residual is affine except for a small nonlinear block (e.g.
    multiphase's softmax, multiphase_dolfinx.py:83-90) provide

      nl_core(x, coeffs, consts, extra) -> (N, K) ELL delta
      lin_data(coeffs, consts)          -> (N, K) f64 tensor (cached by
                                           the model)
      extra: dict of device index tensors nl_core reads.

    fused_newton_btlu then assembles J(x) = lin + nl(x) per iteration
    instead of re-differentiating all fields through jacfwd."""

    def __init__(self, nl_core, lin_data, extra):
        self.nl_core = nl_core
        self.lin_data = lin_data
        self.extra = dict(extra)


class NonlinearProblem:
    def __init__(self, form: VolumeForm, bcs: Sequence[DirichletBC] = (),
                 coeffs: Optional[Mapping] = None,
                 consts: Optional[Mapping] = None):
        self.form = form
        self.space = form.space
        self.device = form.device
        self._direction_cache = {}
        self.set_bc_arrays(*self.space.global_bc_arrays(list(bcs)))
        self.coeffs = dict(coeffs or {})
        self.consts = dict(consts or {})

    def set_bc_arrays(self, bc_idx, bc_vals):
        """Set the Dirichlet dofs and values (e.g. a load step's moving
        boundary data): the device index and values and the host copy of
        the index change together. A new set of dofs drops the ELL
        operator and the direction solvers built on the old one."""
        idx = np.asarray(bc_idx, dtype=np.int64)
        old = getattr(self, "_bc_idx_host", None)
        if old is not None and not np.array_equal(old, idx):
            self.__dict__.pop("_ell", None)
            self._direction_cache.clear()
        self._bc_idx_host = idx
        self.bc_idx = torch.as_tensor(idx, device=self.device)
        self.bc_vals = torch.as_tensor(np.asarray(bc_vals),
                                       dtype=self.form.dtype,
                                       device=self.device)

    # -------------------------------------------------------------- data

    def update(self, coeffs: Optional[Mapping] = None,
               consts: Optional[Mapping] = None):
        if coeffs:
            self.coeffs.update(coeffs)
        if consts:
            self.consts.update(consts)

    # ---------------------------------------------------------------- BC

    def set_bc(self, x):
        """Overwrite bc dofs with their prescribed values."""
        return self.form._as(x).index_put((self.bc_idx,), self.bc_vals)

    def zero_bc(self, v):
        return v.index_fill(0, self.bc_idx, 0.0)

    # --------------------------------------------------------- operators

    def _bc_residual(self, x, F):
        return F.index_put((self.bc_idx,), x[self.bc_idx] - self.bc_vals)

    def residual(self, x):
        """BC-consistent residual: interior rows from the form, bc rows
        x[bc] - g (SNES set_bc convention, problem.py:67)."""
        x = self.form._as(x)
        return self._bc_residual(
            x, self.form.residual(x, self.coeffs, self.consts))

    def jacobian_action(self, x):
        """Returns the matrix-free operator v -> J(x) v with symmetric BC
        handling: J_mod = P J P + (I - P), P zeroing bc entries."""
        coeffs, consts = self.coeffs, self.consts
        form = self.form

        def Av(v):
            y = form.jacobian_action(x, self.zero_bc(v), coeffs, consts)
            return self.zero_bc(y).index_add(0, self.bc_idx, v[self.bc_idx])

        return Av

    @property
    def ell_matrix(self):
        """Lazily-built ELL operator (pattern on host, data assembled on
        the device per Newton step) — the PETSc-AIJ replacement."""
        if not hasattr(self, "_ell"):
            from ..la.ell import EllMatrix, EllPattern
            pattern = EllPattern.build(self.form.local_indices,
                                       self.space.num_dofs,
                                       self._bc_idx_host)
            self._ell = EllMatrix(pattern, self.form.dtype, self.device)
        return self._ell

    def ell_data(self, x):
        """Device-assembled ELL Jacobian data at x (BCs applied)."""
        Ae = self.form._element_matrices_core(x, self.coeffs, self.consts)
        return self.ell_matrix.assemble(Ae)

    def line_blocking(self):
        """Cached LineBlocking of this problem's ELL pattern (raises
        ValueError when the dof graph is not line-structured)."""
        if not hasattr(self, "_line_blocking"):
            from ..la.blocktri import LineBlocking
            dof_nodes, _, node_pts = self.nd_ordering_data()
            self._line_blocking = LineBlocking.build(
                self.ell_matrix.pattern, node_pts[dof_nodes])
        return self._line_blocking

    def direction_solver(self, ksp: str, pc: str, mat_type: str = "ell",
                         schur_field0: Optional[str] = None,
                         precision: str = "double",
                         pc_opts: Optional[Mapping] = None):
        """One device Newton-direction solver per option set:
        (x, F, coeffs, consts, rtol, atol, maxiter, dx0=None) -> dx solving
        J(x) dx = -F on the device. mat_type 'ell' assembles the Jacobian
        once into an ELL matrix (cheap SpMV per Krylov iteration);
        'matfree' re-applies the jvp of the residual each iteration.
        precision='mixed' (ell + jacobi, schur or schur_mg) runs the
        equilibrated inner Krylov in f32 wrapped in f64 iterative
        refinement. pc='schur'/'schur_mg' (ell + minres) applies the
        block-Schur preconditioner of la/schur.py with block0 =
        `schur_field0`."""
        key = (ksp, pc, mat_type, schur_field0, precision,
               tuple(sorted((pc_opts or {}).items())))
        if key not in self._direction_cache:
            self._direction_cache[key] = self._make_direction_fn(
                ksp, pc, mat_type, schur_field0, precision, pc_opts)
        return self._direction_cache[key]

    def _make_direction_fn(self, ksp: str, pc: str, mat_type: str = "ell",
                           schur_field0: Optional[str] = None,
                           precision: str = "double",
                           pc_opts: Optional[Mapping] = None):
        """Direction-solve body shared by direction_solver and the fused
        Newton: (x, F, coeffs, consts, rtol, atol, maxiter, dx0=None) -> dx
        with J(x) dx = -F."""
        from ..la import krylov as kry
        if precision == "mixed" and (mat_type != "ell"
                                     or pc not in ("jacobi", "schur",
                                                   "schur_mg")):
            raise ValueError("precision='mixed' requires mat_type='ell' "
                             "and pc in ('jacobi', 'schur', 'schur_mg')")
        form = self.form
        ell = self.ell_matrix if mat_type == "ell" else None
        pc_opts = dict(pc_opts or {})
        refine_max = int(pc_opts.get("ksp_refine_max", 30))
        if pc == "btlu":
            if mat_type != "ell":
                raise ValueError("pc='btlu' requires mat_type='ell'")
            bt_direction = self._make_bt_direction(pc_opts)
        if pc in ("schur", "schur_mg"):
            if mat_type != "ell" or ksp != "minres":
                raise ValueError(f"pc={pc!r} requires mat_type='ell' and "
                                 "ksp='minres'")
            schur_direction = self._make_schur_direction(
                pc, schur_field0, precision, pc_opts)

        def direction(x, F, coeffs, consts, rtol, atol, maxiter, dx0=None):
            if mat_type == "ell":
                data = ell.assemble(form._element_matrices_core(
                    x, coeffs, consts))

                def Av(v):
                    return ell.spmv(data, v)
            else:
                def Av(v):
                    f = lambda y: form._jacobian_residual_core(y, coeffs,
                                                               consts)
                    y = jvp(f, (x,), (self.zero_bc(v),))[1]
                    return self.zero_bc(y).index_add(0, self.bc_idx,
                                                     v[self.bc_idx])

            b = -F
            if pc == "btlu":
                return bt_direction(data, Av, b, rtol, atol)
            if pc in ("schur", "schur_mg"):
                return schur_direction(data, Av, b, rtol, atol, maxiter,
                                       dx0)
            if pc == "jacobi":
                if mat_type == "ell":
                    d = ell.diagonal(data)
                else:
                    d = form._diagonal_core(x, coeffs, consts)
                    d = d.index_fill(0, self.bc_idx, 1.0)
                # Symmetric Jacobi equilibration: solve (SAS) y = S b with
                # S = |diag|^{-1/2}, dx = S y — two-sided Jacobi
                # preconditioning that keeps every Krylov inner product
                # O(1)-scaled.
                s = torch.where(torch.abs(d) > 1e-300,
                                1.0 / torch.sqrt(torch.abs(d)), 1.0)
                sgn = torch.where(d < 0, -1.0, 1.0)

                def Av_s(v):
                    return s * Av(s * v)

                if precision == "mixed":
                    # equilibrated inner Krylov in f32 + f64 iterative
                    # refinement (the obstacle_p1 scheme)
                    data32 = data.to(f32)
                    s32 = s.to(f32)
                    sgn32 = sgn.to(f32)

                    def Av_s32(v):
                        return s32 * ell.spmv(data32, s32 * v)

                    inner_tol = 2e-6

                    def solve32(r64):
                        bt = (s * r64).to(f32)
                        if ksp == "minres":
                            y = kry.minres(Av_s32, bt, tol=inner_tol,
                                           maxiter=maxiter)
                        elif ksp == "cg":
                            y = kry.cg(Av_s32, bt, tol=inner_tol,
                                       maxiter=maxiter)
                        elif ksp == "gmres_d":
                            y = kry.gmres_givens(Av_s32, bt, tol=inner_tol,
                                                 maxiter=maxiter, restart=60)
                        elif ksp == "bicgstab":
                            y = kry.bicgstab(Av_s32, bt, tol=inner_tol,
                                             maxiter=maxiter,
                                             M=lambda v: sgn32 * v)
                        else:
                            raise ValueError(
                                f"mixed precision: unsupported ksp {ksp!r}")
                        return s * y.to(s.dtype)

                    return _refined(solve32, Av, b, rtol, atol, refine_max,
                                    dx0=dx0)

                bs = s * b
                y0 = None if dx0 is None else dx0 / s
                if ksp == "minres":
                    y = kry.minres(Av_s, bs, x0=y0, tol=rtol, atol=atol,
                                   maxiter=maxiter)
                elif ksp == "cg":
                    y = kry.cg(Av_s, bs, x0=y0, tol=rtol, atol=atol,
                               maxiter=maxiter)
                elif ksp == "gmres":
                    y = kry.gmres(Av_s, bs, x0=y0, tol=rtol, atol=atol,
                                  maxiter=maxiter, restart=30)
                elif ksp == "gmres_d":
                    y = kry.gmres_givens(Av_s, bs, x0=y0, tol=rtol,
                                         atol=atol, maxiter=maxiter,
                                         restart=60)
                elif ksp == "bicgstab":
                    # scaled-diagonal sign as preconditioner keeps the
                    # stabilized recurrence well-behaved on saddle systems
                    y = kry.bicgstab(Av_s, bs, x0=y0, tol=rtol, atol=atol,
                                     maxiter=maxiter, M=lambda v: sgn * v)
                else:
                    raise ValueError(f"unknown ksp_type {ksp!r}")
                return s * y
            # every branch honors dx0 so ksp_chunk_it warm restarts make
            # progress across chunks
            if ksp == "minres":
                return kry.minres(Av, b, x0=dx0, tol=rtol, atol=atol,
                                  maxiter=maxiter)
            if ksp == "cg":
                return kry.cg(Av, b, x0=dx0, tol=rtol, atol=atol,
                              maxiter=maxiter)
            if ksp == "gmres":
                return kry.gmres(Av, b, x0=dx0, tol=rtol, atol=atol,
                                 maxiter=maxiter, restart=30)
            if ksp == "gmres_d":
                return kry.gmres_givens(Av, b, x0=dx0, tol=rtol, atol=atol,
                                        maxiter=maxiter, restart=60)
            if ksp == "bicgstab":
                return kry.bicgstab(Av, b, x0=dx0, tol=rtol, atol=atol,
                                    maxiter=maxiter)
            raise ValueError(f"unknown ksp_type {ksp!r}")

        return direction

    def _make_schur_direction(self, pc: str, schur_field0, precision: str,
                              pc_opts: Mapping):
        """The block-Schur MINRES direction (pc='schur'/'schur_mg'):
        (data, Av, b, rtol, atol, maxiter, dx0) -> dx. Block0 is
        `schur_field0` (comma-separated names form one block; default the
        first field). The system is equilibrated first: per dof,
        S A S with S = |diag|^-1/2, for 'schur'; per field, one scalar a
        field with the bc rows left at 1, for 'schur_mg' (a per-dof scale
        would flatten the P2 vertex/edge diagonal into a checkerboard
        coefficient the V-cycle cannot smooth). precision='mixed' runs
        MINRES in f32 to 1e-6 on the f32 preconditioner, inside f64
        iterative refinement (ksp_refine_max passes, default 30)."""
        from ..la import krylov as kry
        from ..la.schur import make_schur_mg_pc, make_schur_pc
        space, dev, dtype = self.space, self.device, self.form.dtype
        ell = self.ell_matrix
        f0 = schur_field0 or space.names[0]
        f0_names = [n.strip() for n in str(f0).split(",")]
        m0_np = np.zeros(space.num_dofs)
        for name in f0_names:
            m0_np[space.slice_of(name)] = 1.0
        bc1_np = np.zeros(space.num_dofs)
        bci = self._bc_idx_host
        bc1_np[bci] = 1.0 - m0_np[bci]
        m0 = torch.as_tensor(m0_np, dtype=dtype, device=dev)
        bc1 = torch.as_tensor(bc1_np, dtype=dtype, device=dev)
        schur_kw = dict(
            cheb_steps=int(pc_opts.get("pc_schur_cheb_steps", 4)),
            power_iters=int(pc_opts.get("pc_schur_power_iters", 10)),
            lmin_ratio=float(pc_opts.get("pc_schur_lmin_ratio", 30.0)))
        if pc == "schur_mg":
            # the lattice geometry of the (single, scalar) block1 field:
            # its dofs must form a complete 2D lattice
            from ..la.gmg import lattice_map, mg_levels_for
            f1_names = [n for n in space.names if n not in f0_names]
            if len(f1_names) != 1 or \
                    space.spaces[f1_names[0]].value_size != 1:
                raise ValueError("pc='schur_mg' needs exactly one scalar "
                                 "block1 field")
            f1 = f1_names[0]
            perm_loc, grid_shape = lattice_map(space.spaces[f1].dof_points)
            perm_np = space.offsets[f1] + perm_loc
            bc_set = np.zeros(space.num_dofs, dtype=bool)
            bc_set[bci] = True
            perm = torch.as_tensor(perm_np, device=dev)
            free = torch.as_tensor((~bc_set[perm_np]).reshape(grid_shape),
                                   device=dev)
            levels = mg_levels_for(min(grid_shape))
            nu = int(pc_opts.get("pc_mg_nu", 2))
            fmasks = []
            for name in space.names:
                fm = np.zeros(space.num_dofs)
                fm[space.slice_of(name)] = 1.0
                fmasks.append(torch.as_tensor(fm, dtype=dtype, device=dev))

        def build_pc(d, m0_t, bc1_t):
            if pc == "schur":
                return make_schur_pc(ell, d, m0_t, bc1_t, **schur_kw)
            return make_schur_mg_pc(ell, d, m0_t, bc1_t, perm, grid_shape,
                                    free, levels, nu=nu)

        refine_max = int(pc_opts.get("ksp_refine_max", 30))
        cols = ell.arrays["ell_cols"]

        def direction(data, Av, b, rtol, atol, maxiter, dx0=None):
            d = ell.diagonal(data)
            if pc == "schur_mg":
                s = torch.zeros_like(d)
                for fm in fmasks:
                    cnt = torch.clamp(torch.sum(fm), min=1.0)
                    mean_d = torch.sum(torch.abs(d) * fm) / cnt
                    s = s + fm / torch.sqrt(torch.clamp(mean_d, min=1e-300))
                # bc rows stay identity in the scaled system (the +2 bc1
                # Schur correction assumes a unit bc diagonal)
                s = s.index_fill(0, self.bc_idx, 1.0)
            else:
                s = torch.where(torch.abs(d) > 1e-300,
                                1.0 / torch.sqrt(torch.abs(d)), 1.0)
            data_s = s[:, None] * data * s[cols]
            if precision == "mixed":
                data32 = data_s.to(f32)
                Minv32 = build_pc(data32, m0.to(f32), bc1.to(f32))

                def solve_lo(r64):
                    y = kry.minres(lambda v: ell.spmv(data32, v),
                                   (s * r64).to(f32), tol=1e-6,
                                   maxiter=maxiter, Minv=Minv32)
                    return s * y.to(s.dtype)

                return _refined(solve_lo, Av, b, rtol, atol, refine_max,
                                dx0=dx0)
            Minv = build_pc(data_s, m0, bc1)
            y0 = None if dx0 is None else dx0 / s
            y = kry.minres(lambda v: ell.spmv(data_s, v), s * b, x0=y0,
                           tol=rtol, atol=atol, maxiter=maxiter, Minv=Minv)
            return s * y

        return direction

    def _make_bt_direction(self, pc_opts: Mapping):
        """The block-tridiagonal direct direction of the fused Newton
        (pc='btlu' without lag): (data, Av, b, rtol, atol) -> dx. Assemble
        -> equilibrate -> factor -> solve, then refinement passes against
        the assembled operator until ksp tolerance, a stall or
        ksp_refine_max corrections (default 6); one host read a pass. A
        NaN residual refines on, as the reference's fixed-budget scan
        does. Thomas or streamed, as in the reference."""
        from ..la import blocktri as btm
        blocking = self.line_blocking()
        fdt = btm.factor_dtype(pc_opts.get("pc_factor_dtype", "f32"))
        Fact = btm.factorization(
            blocking, fdt, streamed=bool(pc_opts.get("pc_factor_streamed",
                                                     False)))
        passes = int(pc_opts.get("ksp_refine_max", 6))
        ell = self.ell_matrix

        def direction(data, Av, b, rtol, atol):
            fact = Fact(blocking, ell, data, ell.arrays, dtype=fdt)
            stop2 = torch.clamp(rtol * rtol * torch.dot(b, b),
                                min=atol * atol)
            return btm.refine(fact.solve, Av, b, stop2, passes,
                              stop_on_nan=False)[0]

        return direction

    def _fused_residual(self, coeffs, consts):
        """(residual, fsq) of the fused solvers at these coefficients:
        the BC-consistent residual and its squared 2-norm."""
        form = self.form

        def residual(z):
            return self._bc_residual(
                z, form._residual_core(z, coeffs, consts))

        def fsq(z):
            F = residual(z)
            return torch.dot(F, F)

        return residual, fsq

    def fused_newton(self, ksp: str, pc: str, mat_type: str = "ell",
                     linesearch: str = "none", max_it: int = 100,
                     ksp_max_it: int = 10_000, schur_field0=None,
                     pc_opts: Optional[Mapping] = None):
        """Whole-solve Newton on the device: residual -> Krylov direction
        -> linesearch -> update, as one device loop (newton_loop) that
        reads its condition once per Newton step (the Krylov loops inside
        read once per chunk). SNES semantics preserved: the returned
        (it, fnorm, f0, ls_ok, sconv) suffice to reconstruct the converged
        reason on the host, from one read.

        Returns fn(x0, coeffs, consts, rtol, atol, stol, ksp_rtol,
        ksp_atol, damping, it_cap) -> (x, it, fnorm, f0, ls_ok, sconv),
        all tensors on the device.
        """
        key = ("fused", ksp, pc, mat_type, linesearch, max_it, ksp_max_it,
               schur_field0, tuple(sorted((pc_opts or {}).items())))
        if key in self._direction_cache:
            return self._direction_cache[key]

        direction = self._make_direction_fn(ksp, pc, mat_type, schur_field0,
                                            pc_opts=pc_opts)

        def fn(x0, coeffs=None, consts=None, rtol=1e-8, atol=1e-50,
               stol=0.0, ksp_rtol=1e-10, ksp_atol=0.0, damping=1.0,
               it_cap=None):
            coeffs = dict(coeffs if coeffs is not None else self.coeffs)
            consts = dict(consts if consts is not None else self.consts)
            cap = min(max_it if it_cap is None else int(it_cap), max_it)
            residual, fsq = self._fused_residual(coeffs, consts)

            def step(x, F):
                return direction(x, F, coeffs, consts, ksp_rtol, ksp_atol,
                                 ksp_max_it)

            def search(x, dx, fnorm):
                return _fused_linesearch(linesearch, residual, fsq, x, dx,
                                         fnorm, damping)

            return newton_loop(residual, torch.linalg.norm, step, search,
                               self.set_bc(x0), rtol, atol, stol, cap)

        self._direction_cache[key] = fn
        return fn

    def fused_newton_btlu(self, linesearch: str = "none", max_it: int = 100,
                          pc_opts: Optional[Mapping] = None):
        """Whole-solve Newton with a LAGGED block-tridiagonal direct
        direction — the multiphase-record architecture.

        The factor (f64 recursion, f32-cast apply by default, see
        la/blocktri.py) is kept on the returned function across Newton
        steps AND across calls, so consecutive solves of the LVPP alpha
        loop reuse it. Each Newton step first refines the carried factor
        against the CURRENT assembled Jacobian; only when refinement
        misses ksp tolerance (a stale factor) does it refactor. The Newton
        loop is newton_loop (one host read a Newton step, on which the
        refactor decision is a host branch); the refinement inside is a
        device loop read once a pass.

        Returns fn(x0, coeffs, consts, rtol, atol, stol, ksp_rtol,
        ksp_atol, damping, it_cap, timer) -> (x, it, fnorm, f0, ls_ok,
        sconv) as device tensors; fn.reset() drops the factor,
        fn.last_refactors is the refactor count of the last call. With a
        PhaseTimer, the Jacobian assembly, factor, refinement and line
        search (with the stol test and the new residual) are timed as
        'bt_assemble', 'bt_factor', 'bt_solve' and 'linesearch'.
        """
        pc_opts = dict(pc_opts or {})
        split = getattr(self, "ell_split", None)
        key = ("fused_btlu", linesearch, max_it, split is not None,
               tuple(sorted((k, str(v)) for k, v in pc_opts.items())))
        if key in self._direction_cache:
            return self._direction_cache[key]

        from ..la import blocktri as btm
        form = self.form
        ell = self.ell_matrix
        blocking = self.line_blocking()
        fdt = btm.factor_dtype(pc_opts.get("pc_factor_dtype", "f32"))
        algo = str(pc_opts.get("pc_factor_algo", "thomas"))
        if not blocking.fits_dense(8 if fdt == "f64" else 4, algo):
            raise ValueError("fused lagged btlu requires the dense factor "
                             "layout to fit LineBlocking.max_bytes at the "
                             "requested factor dtype "
                             "(LineBlocking.fits_dense)")
        adt = str(pc_opts.get("pc_factor_apply_dtype", "f32"))
        btm._check_apply_dtype(fdt, adt)
        biv = str(pc_opts.get("pc_factor_blockinv", "ns"))
        Fact = btm.factorization(blocking, fdt, algo)
        passes = int(pc_opts.get("ksp_refine_max", 8))

        def fn(x0, coeffs=None, consts=None, rtol=1e-8, atol=1e-50,
               stol=0.0, ksp_rtol=1e-10, ksp_atol=0.0, damping=1.0,
               it_cap=None, timer=None):
            coeffs = dict(coeffs if coeffs is not None else self.coeffs)
            consts = dict(consts if consts is not None else self.consts)
            cap = min(max_it if it_cap is None else int(it_cap), max_it)
            phase = (timer.phase if timer is not None
                     else lambda name: contextlib.nullcontext())
            lin_data = None if split is None else split.lin_data(coeffs,
                                                                 consts)
            residual, fsq = self._fused_residual(coeffs, consts)
            fn.last_refactors = 0

            def step(x, F):
                with phase("bt_assemble"):
                    if split is None:
                        data = ell.assemble(form._element_matrices_core(
                            x, coeffs, consts))
                    else:
                        data = lin_data + split.nl_core(x, coeffs, consts,
                                                        split.extra)

                def Av(v):
                    return ell.spmv(data, v)

                b = -F
                stop2 = torch.clamp(ksp_rtol * ksp_rtol * torch.dot(b, b),
                                    min=ksp_atol * ksp_atol)
                ok = False
                if fn._fact is not None:
                    with phase("bt_solve"):
                        dx, ok_t, _ = btm.refine(fn._fact.solve, Av, b,
                                                 stop2, passes)
                        ok = bool(ok_t)
                if not ok:
                    with phase("bt_factor"):
                        fn._fact = Fact(blocking, ell, data, ell.arrays,
                                        dtype=fdt, apply_dtype=adt,
                                        blockinv=biv)
                    fn.last_refactors += 1
                    # a fresh factor's best dx is accepted regardless
                    with phase("bt_solve"):
                        dx = btm.refine(fn._fact.solve, Av, b, stop2,
                                        passes)[0]
                return dx

            def search(x, dx, fnorm):
                return _fused_linesearch(linesearch, residual, fsq, x, dx,
                                         fnorm, damping)

            return newton_loop(residual, torch.linalg.norm, step, search,
                               self.set_bc(x0), rtol, atol, stol, cap,
                               lambda: phase("linesearch"))

        fn._fact = None
        fn.last_refactors = 0

        def reset():
            fn._fact = None

        fn.reset = reset
        self._direction_cache[key] = fn
        return fn

    def jacobian_scipy(self, x, timer=None):
        """Assembled CSR with bc rows/cols zeroed and unit diagonal: the
        element matrices on the device, scattered into the ELL pattern's
        sorted-unique (row, col) CSR slots on the host. With a PhaseTimer,
        the device assembly, the copy to the host and the scatter are
        timed as 'assembly', 'host_transfer' and 'csr'."""
        import scipy.sparse as sp
        from ..native import scatter_add
        phase = (timer.phase if timer is not None
                 else lambda name: contextlib.nullcontext())
        ell = self.ell_matrix
        pat = ell.pattern
        # models whose residual is affine except for a small nonlinear term
        # (e.g. multiphase's softmax) can install csr_data_override to
        # produce the unassembled-bc CSR data (host numpy) directly from
        # cached constant data + a scatter of only the nonlinear block
        override = getattr(self, "csr_data_override", None)
        if override is not None:
            with phase("assembly"):
                data = np.asarray(override(x, self.coeffs, self.consts))
        else:
            with phase("assembly"):
                Ae = self.form.element_matrices(x, self.coeffs, self.consts)
            with phase("host_transfer"):
                count("host_reads")
                Ae = Ae.cpu().numpy()
            with phase("csr"):
                data = scatter_add(Ae.reshape(-1).astype(np.float64),
                                   pat.slot_map.astype(np.int64), pat.nnz)
        with phase("csr"):
            data = data * pat.keep + pat.diag_ones
            N = pat.num_dofs
            # slots are sorted by (row, col): build CSR arrays directly
            if not hasattr(self, "_csr_struct"):
                li = self.form.local_indices
                rows = np.repeat(li, li.shape[1], axis=1).reshape(-1)
                cols = np.tile(li, (1, li.shape[1])).reshape(-1)
                key = rows.astype(np.int64) * N + cols.astype(np.int64)
                uniq = np.unique(key)
                urow = (uniq // N).astype(np.int64)
                ucol = (uniq % N).astype(np.int32)
                indptr = np.zeros(N + 1, dtype=np.int64)
                np.add.at(indptr, urow + 1, 1)
                np.cumsum(indptr, out=indptr)
                self._csr_struct = (ucol, indptr)
            ucol, indptr = self._csr_struct
            return sp.csr_matrix((data, ucol, indptr), shape=(N, N))

    def jacobian_diagonal(self, x):
        d = self.form.jacobian_diagonal(x, self.coeffs, self.consts)
        return d.index_fill(0, self.bc_idx, 1.0)

    def nd_ordering_data(self):
        """(dof_nodes, field_of, node_pts) for la/ordering's geometric
        nested dissection: every dof carrying the same physical point
        (across fields and vector components) joins one supernode, the
        granularity at which MUMPS/METIS orders node-block FEM systems."""
        if hasattr(self, "_nd_data"):
            return self._nd_data
        space = self.space
        nd = space.num_dofs
        gdim = space.mesh.gdim
        P = np.zeros((nd, gdim))
        field_of = np.empty(nd, dtype=np.int64)
        for fi, name in enumerate(space.names):
            S = space.spaces[name]
            sl = space.slice_of(name)
            field_of[sl] = fi
            local = np.arange(sl.stop - sl.start)
            P[sl] = S.dof_points[local // max(S.value_size, 1)]
        span = max(float(P.max() - P.min()), 1.0)
        quant = np.round(P / (1e-8 * span)).astype(np.int64)
        _, dof_nodes = np.unique(quant, axis=0, return_inverse=True)
        n_nodes = int(dof_nodes.max()) + 1
        node_pts = np.zeros((n_nodes, gdim))
        node_pts[dof_nodes] = P
        self._nd_data = (dof_nodes.astype(np.int64), field_of, node_pts)
        return self._nd_data
