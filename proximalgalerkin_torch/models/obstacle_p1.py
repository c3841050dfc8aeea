"""Example 01 fast path — P1 lumped-mass proximal Galerkin, in PyTorch.

The production/bench variant of the obstacle problem. Same LVPP structure
as the reference (obstacle_pg.py:116-124), discretized with P1 Lagrange
and vertex (lumped) quadrature for the latent coupling terms, so the
latent block is pointwise diagonal and each Newton step reduces exactly
to the SPD Schur system

    (alpha A + M_L^2 / D) du = rhs,     D = M_L * exp(psi),

solved by preconditioned CG. The outer LVPP loop follows the reference's
FD protocol (obstacle_finite_difference.jl:70-111): alpha = min(max(C
r^(q^k) - alpha, C), cap), outer l2 increment tolerance.

Host setup (mesh, P1 space, ELL pattern, closed-form affine-triangle
stiffness, lumped mass, DIA packing) is numpy; everything after it runs
in torch on the `device` the caller names. There is no JIT: the Newton
and CG loops are host loops that read a device scalar once per Newton
step, once per refinement decision and once per CG chunk.

Branches of the inner solve:
  f64, pc="jacobi"   Jacobi-preconditioned CG (`_cg`)
  f64, pc="mg"       CG preconditioned by the f32 lattice V-cycle (ops/mg)
  mixed, pc="mg"     f32 fused MG-PCG (ops/mgfused: the CUDA kernel on a
                     CUDA device, its plain version on the CPU) inside two
                     f64 refinement passes
  mixed, pc="jacobi" f32 Jacobi-CG inside two f64 refinement passes: on
                     the DIA operator the fused DIA-CG (ops/dia_cg: the
                     CUDA kernels on a CUDA device, their plain version on
                     the CPU) on the Jacobi-scaled operator folded into one
                     DIA matrix (effective_dia); on ELL the un-fused `_cg`

On a CUDA device every DIA SpMV (f64 residuals, Schur right-hand sides,
refinement matvecs, back-substitution) runs the DIA kernel of
ops/dia_spmv.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..la.dia import DiaMatrix
from ..la.ell import EllMatrix, EllPattern
from ..mesh.mesh import Mesh
from ..native import scatter_add
from ..ops import dia_cg, mg, mgfused
from ..spaces import FunctionSpace
from .obstacle import spherical_cap_obstacle

f32 = torch.float32


@dataclass
class P1ObstacleResult:
    u: np.ndarray
    psi: np.ndarray
    outer_iterations: int
    newton_its: int
    newton_per_outer: List[int]
    increments: List[float]
    converged: bool
    cg_its_total: int = 0      # inner CG iterations


# When the f32 inner CG reaches its noise floor just above the requested
# relative tolerance it can cycle without progress for the rest of its
# budget. Once the best residual is already within _CG_STALL_GUARD of the
# stop threshold, exit after _CG_STALL_WINDOW iterations without
# improvement and return the best iterate seen.
_CG_STALL_WINDOW = 128
_CG_STALL_GUARD = 1e4

# Active/free split: nodes whose latent weight M^2/d exceeds the elliptic
# row scale by KAPPA_MAX take their closed-form Newton limit; PSI_TOP
# guards exp overflow.
KAPPA_MAX = 1e14
PSI_TOP = 50.0


def _cg(matvec, b, Minv, tol, maxiter, stall_guard=_CG_STALL_GUARD):
    """Jacobi-preconditioned CG (ops/mg.pcg with z = Minv * r and the
    longer stall window). stall_guard=0.0 disarms the noise-floor exit
    (pure-f64 callers, which have no refinement wrap)."""
    return mg.pcg(matvec, b, lambda r: Minv * r, tol, maxiter,
                  stall_window=_CG_STALL_WINDOW, stall_guard=stall_guard)


def effective_dia(offsets, A32: torch.Tensor, free: torch.Tensor,
                  sqinv32: torch.Tensor, m2d32: torch.Tensor,
                  alpha32: float) -> torch.Tensor:
    """The masked, Jacobi-scaled f32 Schur operator of the mixed Jacobi-CG
    folded into one DIA matrix (ndiags, N), as the reference builds it for
    its fused DIA-CG (models/obstacle_p1.py:576-597):

        eff[d, i] = fs[i] * alpha * A[d, i] * fs[i + off[d]]
        eff[0, i] += m2d[i] / diagS[i] + (1 - free[i]) / diagS[i]

    with fs = free * diagS^-1/2 (identity rows where not free, whose diagS
    is 1), fs[j] = 0 outside [0, N)."""
    fs = torch.where(free, sqinv32, 0.0)
    n = fs.shape[0]
    notfree = torch.where(free, 0.0, 1.0).to(f32)
    rows = []
    for k, off in enumerate(offsets):
        shifted = torch.zeros_like(fs)
        if 0 <= off < n:
            shifted[:n - off] = fs[off:]
        elif 0 < -off < n:
            shifted[-off:] = fs[:n + off]
        row = fs * alpha32 * A32[k] * shifted
        if off == 0:
            row = (row + m2d32 * sqinv32 * sqinv32
                   + notfree * sqinv32 * sqinv32)
        rows.append(row)
    return torch.stack(rows)


def _assemble_host(mesh: Mesh, V: FunctionSpace, pattern: EllPattern,
                   dm: np.ndarray, bdofs: np.ndarray, obstacle: Callable,
                   use_dia: bool) -> dict:
    """Host assembly of the P1 operator for affine triangles: the
    stiffness in CSR slots with Dirichlet rows applied, the lumped mass,
    the obstacle at the dofs, the interior mask and the DIA packing."""
    if not (mesh.cell_type == "triangle" and mesh.geom_degree == 1):
        raise NotImplementedError(
            "P1ObstacleSolver assembles affine triangles only; other "
            f"cells ({mesh.cell_type}, degree {mesh.geom_degree}) need the "
            "quadrature assembly stack, which is not ported yet")
    N = V.num_dofs
    # element stiffness |T| grad(lambda_i) . grad(lambda_j) in closed form
    pv = mesh.points[mesh.cell_vertices]              # (e, 3, 2)
    e1 = pv[:, 1] - pv[:, 0]
    e2 = pv[:, 2] - pv[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    area = 0.5 * np.abs(det)
    inv = 1.0 / det
    g1 = np.stack([e2[:, 1] * inv, -e2[:, 0] * inv], axis=1)
    g2 = np.stack([-e1[:, 1] * inv, e1[:, 0] * inv], axis=1)
    g0 = -(g1 + g2)
    G3 = np.stack([g0, g1, g2], axis=1)               # (e, 3, 2)
    Ae = np.einsum("eid,ejd,e->eij", G3, G3, area)
    Me = np.repeat(area[:, None] / 3.0, 3, axis=1)

    csr = scatter_add(Ae.reshape(-1), pattern.slot_map, pattern.nnz + 1)
    csr[:pattern.nnz] = (csr[:pattern.nnz] * pattern.keep
                         + pattern.diag_ones)
    ML = scatter_add(Me.reshape(-1), dm.reshape(-1), N)

    dia = None
    if use_dia:
        # only TRUE csr slots — ELL (row, row, 0.0) padding entries would
        # collide with the genuine diagonal in DIA storage
        K = pattern.width
        eg_flat = np.asarray(pattern.ell_gather).reshape(-1)
        true_mask = eg_flat < pattern.nnz
        rows = np.repeat(np.arange(N, dtype=np.int64), K)[true_mask]
        cols = np.asarray(pattern.ell_cols).reshape(-1)[true_mask]
        dia = DiaMatrix.host_build(rows, cols, csr[eg_flat[true_mask]], N)
    interior = np.ones(N)
    interior[np.asarray(bdofs)] = 0.0
    return dict(A_csr_host=csr,
                dia_offsets=None if dia is None else dia[0],
                dia_data=None if dia is None else dia[1],
                M_L=ML, phi=obstacle(V.dof_points.T), interior=interior)


def _lattice_scale(offsets, data: np.ndarray, interior: np.ndarray,
                   N: int) -> float:
    """The stencil scale s of an isotropic 5-point lattice stiffness (off-
    diagonals -s, diagonal 4s, zero diagonal couplings) at interior rows;
    raises if the DIA operator is not one."""
    m = int(round(np.sqrt(N)))
    ok = (m * m == N
          and set(abs(int(o)) for o in offsets) <= {0, 1, m, m + 1})
    s = 1.0
    if ok:
        offs = [int(o) for o in offsets]
        interior2 = np.asarray(interior, bool).reshape(m, m).copy()
        interior2[[0, -1], :] = False
        interior2[:, [0, -1]] = False
        core = interior2.reshape(-1)
        s_off = {}
        for k_, off in enumerate(offs):
            vals = data[k_][core]
            if abs(off) == m + 1:
                ok = ok and (np.abs(vals).max() < 1e-12)
            elif off != 0:
                s_off[abs(off)] = np.median(np.abs(vals))
        if ok and s_off:
            s = float(np.mean(list(s_off.values())))
            ok = all(abs(v - s) < 1e-10 * max(s, 1.0)
                     for v in s_off.values())
            diag_vals = data[offs.index(0)][core]
            ok = ok and np.allclose(diag_vals, 4.0 * s,
                                    atol=1e-10 * max(s, 1.0))
    if not ok:
        raise ValueError("pc='mg' requires the isotropic 5-point lattice "
                         "stiffness (P1 on rectangle_mesh)")
    return s


class P1ObstacleSolver:
    def __init__(self, mesh: Mesh,
                 obstacle: Callable = spherical_cap_obstacle,
                 f: float = 0.0,
                 alpha_cap: float = 1e2,
                 outer_tol: float = 1e-8,
                 newton_tol: float = 1e-4,
                 newton_atol: float = 1e-11,
                 newton_max: int = 50,
                 cg_tol: float = 1e-10,
                 cg_max: Optional[int] = None,
                 mixed_precision: bool = False,
                 use_dia: bool = True,
                 pc: str = "jacobi",
                 cg_forcing: str = "fixed",
                 dtype: torch.dtype = torch.float64,
                 *,
                 device="cuda",
                 host_arrays: Optional[dict] = None):
        """device: where every tensor of the solve lives (the card unless
        the caller asks for the CPU). host_arrays: the numpy operator (keys of `_assemble_host`) to
        use instead of assembling it from the mesh (see from_arrays)."""
        if cg_forcing not in ("fixed", "ew"):
            raise ValueError(
                f"cg_forcing must be 'fixed' or 'ew', got {cg_forcing!r}")
        if cg_forcing == "ew" and not mixed_precision:
            raise ValueError(
                "cg_forcing='ew' only affects the mixed_precision=True "
                "inner solve; combine it with mixed_precision=True")
        if pc not in ("jacobi", "mg"):
            raise ValueError(f"pc must be 'jacobi' or 'mg', got {pc!r}")
        device = torch.device(device)
        self.mesh = mesh
        self.device = device
        self.dtype = dtype
        V = FunctionSpace.create(mesh, 1)
        self.V = V
        N = V.num_dofs
        self.N = N
        bdofs = V.boundary_dofs()
        dm = V.dofmap.astype(np.int64)                    # (e, 3)
        pattern = EllPattern.build(dm, N, bdofs)
        self.ell = EllMatrix(pattern, dtype, device)
        if host_arrays is None:
            host_arrays = _assemble_host(mesh, V, pattern, dm, bdofs,
                                         obstacle, use_dia)
        h = host_arrays
        self.A_csr_host = h["A_csr_host"]

        def dev(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        if h["dia_offsets"] is not None:
            self.dia = DiaMatrix(
                offsets=tuple(int(o) for o in h["dia_offsets"]),
                data=dev(h["dia_data"]), n=N)
            self.A_data = self.dia.data
        else:
            self.dia = None
            self.A_data = dev(self.A_csr_host[pattern.ell_gather])
        self.M_L = dev(h["M_L"])
        self.phi = dev(h["phi"])
        self.interior = dev(h["interior"])
        self.f = f
        self.alpha_cap = alpha_cap
        self.outer_tol = outer_tol
        self.newton_tol = newton_tol
        self.newton_atol = newton_atol
        self.newton_max = newton_max
        self.cg_tol = cg_tol
        self.cg_max = cg_max or 40 * int(np.sqrt(N))
        self.cg_forcing = cg_forcing
        self.mixed_precision = mixed_precision
        self.pc = pc
        # f32 operator for the mixed Jacobi-CG branch
        self.A32 = (self.A_data.to(f32)
                    if mixed_precision and pc == "jacobi" else None)

        # lattice V-cycle: needs the isotropic 5-point stencil (P1 on
        # rectangle_mesh), verified on the host DIA data
        self._mg_scale = 1.0
        self._mg_m = int(round(np.sqrt(N)))
        if pc == "mg":
            if self.dia is None:
                raise ValueError("pc='mg' requires the isotropic 5-point "
                                 "lattice stiffness (P1 on rectangle_mesh)")
            self._mg_scale = _lattice_scale(h["dia_offsets"], h["dia_data"],
                                            h["interior"], N)
            self._mg_setup = mg.make_mg_pc(self._mg_m)
            self._mg_nlev = len(mg._levels_for(self._mg_m))

    @classmethod
    def from_arrays(cls, mesh: Mesh, *, A_csr_host, dia_offsets, dia_data,
                    M_L, phi, interior, **kwargs) -> "P1ObstacleSolver":
        """A solver on a given operator (e.g. the reference package's
        assembled arrays): the CSR stiffness values with Dirichlet rows
        applied, its DIA packing (offsets and data, or None for ELL), the
        lumped mass, the obstacle at the dofs and the interior mask."""
        arrays = dict(A_csr_host=np.asarray(A_csr_host),
                      dia_offsets=dia_offsets,
                      dia_data=None if dia_data is None
                      else np.asarray(dia_data),
                      M_L=np.asarray(M_L), phi=np.asarray(phi),
                      interior=np.asarray(interior))
        return cls(mesh, host_arrays=arrays, **kwargs)

    # ------------------------------------------------------ operators
    def _spmv(self, A, v):
        if self.dia is not None:
            return self.dia.spmv(v, A)
        return self.ell.spmv(A, v)

    def _diag(self, A):
        if self.dia is not None:
            return self.dia.diagonal(A)
        return self.ell.diagonal(A)

    def residual(self, u, psi, psi_k, alpha: float):
        interior, M_L = self.interior, self.M_L
        g_u = interior * (alpha * self._spmv(self.A_data, u)
                          + M_L * (psi - psi_k - alpha * self.f))
        g_p = interior * M_L * (u - torch.exp(psi) - self.phi)
        return g_u, g_p

    # ---------------------------------------------------- inner solves
    def _mixed_solver(self, free, m2d, diagS, alpha: float, tol32: float):
        """solve32(b64) -> (w, its): the f32 inner solve of the Jacobi-
        scaled system D^{-1/2} S D^{-1/2} (unit diagonal, rows O(1)),
        mapped back to the unscaled f64 direction."""
        dt = self.dtype
        sqinv = 1.0 / torch.sqrt(diagS)
        alpha32 = float(np.float32(alpha))
        if self.pc == "mg":
            m = self._mg_m
            w_mg = torch.where(free, m2d, mg.PIN).to(f32)
            whier = mg.w_hierarchy(w_mg.reshape(m, m), self._mg_nlev)
            B2 = torch.where(free, sqinv, 0.0).to(f32).reshape(m, m)
            C2 = torch.where(free, m2d * sqinv * sqinv,
                             1.0).to(f32).reshape(m, m)
            alpha_s = float(np.float32(alpha32)
                            * np.float32(self._mg_scale))

            def solve32(b64):
                bt2 = (b64 * sqinv).to(f32).reshape(m, m)
                x2, its = mgfused.solve(bt2, B2, C2, whier, alpha_s, tol32,
                                        self.cg_max)
                return x2.reshape(-1).to(dt) * sqinv, its
            return solve32

        sqinv32 = sqinv.to(f32)
        m2d32 = m2d.to(f32)
        if self.dia is not None:
            data_eff = effective_dia(self.dia.offsets, self.A32, free,
                                     sqinv32, m2d32, alpha32)

            def solve32(b64):
                bt = (b64 * sqinv).to(f32)
                xt, its = dia_cg.solve(self.dia.offsets, data_eff, bt, tol32,
                                       self.cg_max)
                return xt.to(dt) * sqinv, its
            return solve32

        ones32 = torch.ones_like(sqinv32)

        def S32t(vt):
            v = vt * sqinv32
            vf = torch.where(free, v, 0.0)
            y = torch.where(free,
                            alpha32 * self._spmv(self.A32, vf) + m2d32 * v,
                            v)
            return y * sqinv32

        def solve32(b64):
            bt = (b64 * sqinv).to(f32)
            xt, its = _cg(S32t, bt, ones32, tol32, self.cg_max)
            return xt.to(dt) * sqinv, its
        return solve32

    def _newton(self, u, psi, psi_k, u_prev, alpha: float):
        """Newton on the LVPP subproblem at fixed alpha. Returns the best
        iterate (u, psi), the Newton and CG iteration counts and the outer
        increment |u - u_prev|."""
        interior, M_L = self.interior, self.M_L
        A = self.A_data
        inner = interior > 0
        g_u, g_p = self.residual(u, psi, psi_k, alpha)
        norm0 = torch.sqrt(torch.dot(g_u, g_u) + torch.dot(g_p, g_p))
        nrm_h = float(norm0)
        # relative tolerance with an absolute floor
        stop_h = max(self.newton_tol * nrm_h, self.newton_atol)
        diagA = self._diag(A)
        best = (u, psi, norm0)
        nrm_prev_h = nrm_h
        it = 0
        cg_total = 0
        while it < self.newton_max and nrm_h > stop_h:
            nrm_in_h = nrm_h
            g_u, g_p = self.residual(u, psi, psi_k, alpha)
            d = M_L * torch.exp(psi)              # underflow to 0 is fine
            row_scale = alpha * diagA + M_L
            active = inner & (d * KAPPA_MAX * row_scale < M_L * M_L)
            free = inner & ~active
            dsafe = torch.clamp_min(d, 1e-300)
            m2d = torch.where(free, M_L * M_L / dsafe, 0.0)
            du_a = torch.where(active,
                               -g_p / M_L - (d / (M_L * M_L)) * g_u, 0.0)
            rhs = torch.where(
                free, -g_u - (M_L / dsafe) * g_p
                - alpha * self._spmv(A, du_a), 0.0)

            def S(v):
                vf = torch.where(free, v, 0.0)
                return torch.where(free, alpha * self._spmv(A, vf) + m2d * v,
                                   v)

            diagS = torch.where(free, alpha * diagA + m2d, 1.0)
            if not self.mixed_precision:
                if self.pc == "mg":
                    # f64 CG, f32 V-cycle PC on the unscaled operator
                    w_mg = torch.where(free, m2d, mg.PIN).to(f32)
                    mgpc = self._mg_setup(
                        float(np.float32(alpha)
                              * np.float32(self._mg_scale)), w_mg)
                    w, cg_its = mg.pcg(
                        S, rhs, lambda r: mgpc(r.to(f32)).to(r.dtype),
                        self.cg_tol, self.cg_max, stall_guard=0.0)
                else:
                    w, cg_its = _cg(S, rhs, 1.0 / diagS, self.cg_tol,
                                    self.cg_max, stall_guard=0.0)
            else:
                tol_fix = max(self.cg_tol, 2e-6)
                if self.cg_forcing == "ew":
                    # Eisenstat-Walker choice 2 with the lower safeguard
                    # 0.1*stop/|F_k|, forced tight in the endgame
                    ratio = nrm_in_h / max(nrm_prev_h, 1e-300)
                    eta = min(max(max(0.9 * ratio * ratio,
                                      0.1 * stop_h / max(nrm_in_h, 1e-300)),
                                  1e-9), 1e-2)
                    if nrm_in_h < 100.0 * stop_h:
                        eta = 1e-9
                    tol32 = float(max(np.float32(tol_fix), np.float32(eta)))
                else:
                    eta = None
                    tol32 = float(np.float32(tol_fix))
                solve32 = self._mixed_solver(free, m2d, diagS, alpha, tol32)
                w, cg_its = solve32(rhs)
                rhsn2 = torch.dot(rhs, rhs)
                # refinement target: fixed ~1e-9 relative (f32 noise
                # floor), or the EW forcing eta
                rthresh = ((eta * eta) * rhsn2 if eta is not None
                           else 1e-18 * rhsn2)
                for _ in range(2):
                    r = torch.where(free, rhs - S(w), 0.0)
                    rn2 = torch.dot(r, r)
                    if bool(rn2 > rthresh):     # one read per decision
                        e, its2 = solve32(r)
                        w = w + e
                        cg_its = cg_its + its2
            du = torch.where(free, w, du_a)
            # back-substitute dpsi from the first (linear) Newton row
            dpsi = torch.where(
                inner, -(g_u + alpha * self._spmv(A, du)) / M_L, 0.0)
            u = u + du
            psi = torch.clamp_max(psi + dpsi, PSI_TOP)
            g_u, g_p = self.residual(u, psi, psi_k, alpha)
            nrm = torch.sqrt(torch.dot(g_u, g_u) + torch.dot(g_p, g_p))
            # keep the best iterate: Newton never returns a worse state
            bu, bp, bn = best
            improved = nrm < bn
            best = (torch.where(improved, u, bu),
                    torch.where(improved, psi, bp), torch.minimum(nrm, bn))
            it += 1
            cg_total = cg_total + cg_its
            nrm_prev_h = nrm_in_h
            nrm_h = float(nrm)                  # one read per Newton step
        u, psi, _ = best
        inc = torch.linalg.norm(u - u_prev)
        return u, psi, it, int(cg_total), float(inc)

    # ------------------------------------------------------ outer loop
    def alpha_schedule(self, max_outer: int = 100) -> np.ndarray:
        """Precomputed FD-rule alpha sequence (host recurrence)."""
        alphas = np.zeros(max_outer)
        alpha, C, r, q = 1.0, 1.0, 1.5, 1.5
        for k in range(max_outer):
            try:
                alpha = min(max(C * r ** (q**k) - alpha, C), self.alpha_cap)
            except OverflowError:
                alpha = self.alpha_cap
            alphas[k] = alpha
        return alphas

    def _lvpp(self, max_outer: int, verbose: bool, inclusive: bool):
        """The outer LVPP loop over the precomputed alpha schedule. Stops
        after the outer step whose increment is below outer_tol (at or
        below it when inclusive). Returns (u, psi, outer steps, Newton
        total, CG total, newton_per_outer, increments)."""
        N, dt, dev = self.N, self.dtype, self.device
        u = torch.zeros(N, dtype=dt, device=dev)
        psi = torch.ones(N, dtype=dt, device=dev)
        psi_k = torch.zeros(N, dtype=dt, device=dev)
        u_prev = torch.zeros(N, dtype=dt, device=dev)
        per_outer: List[int] = []
        increments: List[float] = []
        total = 0
        cg_total = 0
        k_done = 0
        for k, alpha in enumerate(self.alpha_schedule(max_outer)):
            alpha = float(alpha)
            u, psi, nits, cg_its, inc = self._newton(u, psi, psi_k, u_prev,
                                                     alpha)
            total += nits
            cg_total += cg_its
            per_outer.append(nits)
            psi_k = psi
            increments.append(inc)
            k_done = k + 1
            if verbose:
                print(f"outer {k + 1} alpha={alpha:.4g} newton={nits} "
                      f"cg={cg_its} inc={inc:.3e}", flush=True)
            if inc < self.outer_tol or (inclusive and inc == self.outer_tol):
                break
            u_prev = u
        return u, psi, k_done, total, cg_total, per_outer, increments

    def solve(self, max_outer: int = 100, verbose: bool = False
              ) -> P1ObstacleResult:
        u, psi, k_done, total, cg_total, per_outer, increments = self._lvpp(
            max_outer, verbose, inclusive=False)
        return P1ObstacleResult(
            u=u.cpu().numpy(), psi=psi.cpu().numpy(),
            outer_iterations=k_done, newton_its=total,
            newton_per_outer=per_outer, increments=increments,
            converged=bool(increments) and increments[-1] < self.outer_tol,
            cg_its_total=cg_total)

    def solve_fused(self, max_outer: int = 100) -> P1ObstacleResult:
        """The whole LVPP solve with totals only, the counterpart of the
        reference's one-program solve_fused (models/obstacle_p1.py:704):
        it stops once the increment is at or below outer_tol, or when the
        alphas run out, and keeps no per-step records (newton_per_outer
        is empty, increments holds the last one). Its u is that of
        solve()."""
        u, psi, k_done, total, cg_total, _, increments = self._lvpp(
            max_outer, False, inclusive=True)
        inc = increments[-1] if increments else float("inf")
        return P1ObstacleResult(
            u=u.cpu().numpy(), psi=psi.cpu().numpy(),
            outer_iterations=k_done, newton_its=total, newton_per_outer=[],
            increments=[inc], converged=inc < self.outer_tol,
            cg_its_total=cg_total)
