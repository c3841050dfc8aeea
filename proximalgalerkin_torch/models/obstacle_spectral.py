"""Example 01 (spectral variant) — LVPP obstacle problem on the unit disk
with a Zernike polynomial basis, in PyTorch.

The port of the reference package's models/obstacle_spectral.py
(examples/01_obstacle_problem/obstacle_spectral.jl): the latent
nonlinearity is applied in physical (quadrature-grid) space and projected
back through dense transforms (:49-63), with a polynomial-degree sweep
(:88-144). The Galerkin operators (stiffness, mass, basis-to-grid
Vandermonde) are dense matrices on `device`; every Newton step is a dense
matmul and a dense LU (torch.linalg), and the Newton loop is a
la/loop.while_loop that reads the host once per Newton step.

Basis: Zernike functions Z_n^m(r, th) = R_n^m(r) {cos, sin}(m th) with
radial Jacobi-polynomial formula; the primal space is Dirichlet-weighted
(1 - r^2) Z (u = 0 at r = 1), the latent space is unweighted Z. The
tables are numpy, built on the host as the reference builds them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from ..elements.orthopoly import jacobi_all
from ..la.loop import while_loop
from .obstacle import spherical_cap_obstacle


def _zernike_radial_all(p: int, m: int, r: np.ndarray) -> np.ndarray:
    """R_n^m(r) for ALL n = m, m+2, ..., <= p at once: one Jacobi
    recurrence per angular order (jacobi_all) instead of one per (n, m)
    mode. Returns (K+1, nq) with row k = R_{m+2k}^m."""
    K = (p - m) // 2
    P = jacobi_all(1.0 - 2.0 * r**2, float(m), 0.0, K)
    signs = (-1.0) ** np.arange(K + 1)
    return signs[:, None] * (r**m)[None, :] * P


def _disk_quadrature(p: int):
    """Quadrature exact for polynomials of degree ~2p+4 on the unit disk:
    Gauss–Legendre in s = r^2 (absorbs the r dr measure), trapezoid in
    theta (spectral for the periodic direction)."""
    nr = p + 4
    ntheta = 4 * p + 8
    xs, ws = np.polynomial.legendre.leggauss(nr)
    s = 0.5 * (xs + 1.0)
    wr = 0.5 * ws            # integral over s in [0,1]; r dr = ds/2
    r = np.sqrt(s)
    th = np.linspace(0.0, 2.0 * np.pi, ntheta, endpoint=False)
    wth = np.full(ntheta, 2.0 * np.pi / ntheta)
    R, TH = np.meshgrid(r, th, indexing="ij")
    W = 0.5 * np.outer(wr, wth) * 2.0  # r dr dth = (1/2) ds dth
    return R.ravel(), TH.ravel(), W.ravel()


def _basis_tables(p: int, r, th, weighted: bool):
    """Vandermonde V (nq, nbasis) and gradient tables (nq, nbasis, 2) in
    Cartesian components, built by numerical differentiation of the radial
    part (analytic in theta)."""
    modes = []
    for m in range(0, p + 1):
        for n in range(m, p + 1, 2):
            modes.append((n, m, 0))
            if m > 0:
                modes.append((n, m, 1))
    nb = len(modes)
    nq = len(r)
    V = np.zeros((nq, nb))
    Gr = np.zeros((nq, nb))     # d/dr
    Gt = np.zeros((nq, nb))     # (1/r) d/dth (angular physical component)
    h = 1e-6
    rp, rm = np.clip(r + h, 0, None), np.clip(r - h, 0, None)
    w = (1.0 - r**2) if weighted else np.ones_like(r)
    wp = (1.0 - rp**2) if weighted else np.ones_like(r)
    wm = (1.0 - rm**2) if weighted else np.ones_like(r)
    rsafe = np.maximum(r, 1e-12)
    pmax = max(n for n, _, _ in modes)
    # one recurrence pass per angular order and radial grid (r, r+h, r-h)
    rad = {m: (_zernike_radial_all(pmax, m, r),
               _zernike_radial_all(pmax, m, rp),
               _zernike_radial_all(pmax, m, rm))
           for m in sorted({m for _, m, _ in modes})}
    for j, (n, m, s_) in enumerate(modes):
        k = (n - m) // 2
        R0, Rp, Rm = (t[k] for t in rad[m])
        ang = np.cos(m * th) if s_ == 0 else np.sin(m * th)
        dang = (-m * np.sin(m * th)) if s_ == 0 else (m * np.cos(m * th))
        V[:, j] = w * R0 * ang
        dR = (wp * Rp - wm * Rm) / (rp - rm)
        Gr[:, j] = dR * ang
        Gt[:, j] = w * R0 * dang / rsafe
    # Cartesian gradient components
    ct, st = np.cos(th), np.sin(th)
    Gx = Gr * ct[:, None] - Gt * st[:, None]
    Gy = Gr * st[:, None] + Gt * ct[:, None]
    return V, Gx, Gy


@dataclass
class SpectralObstacleResult:
    degrees: List[int]
    newton_its: List[int]
    sup_errors: List[float]
    u_grid_fn: Callable        # u(r, theta) evaluator for the last degree
    phases: List[dict] = None  # per-degree {tabulate_s, operators_s, solve_s}


def spectral_obstacle_solve(p: int, obstacle=spherical_cap_obstacle,
                            alpha_cap: float = 1e2, outer_tol: float = 1e-9,
                            newton_tol: float = 1e-4, newton_max: int = 50,
                            verbose: bool = False,
                            solve_dtype: str = "f64",
                            phases: dict = None, *, device="cuda"):
    """One LVPP solve at Zernike degree p. Returns (u coefficient vector,
    Newton count, evaluator u(r, theta)).

    solve_dtype: 'f64' factors the dense Newton matrix in float64;
    'f32_refine' factors it in float32 and recovers f64 direction accuracy
    with three refinement passes against the f64 operator (the
    reference's device path for the p-sweep, kept for parity). Directions
    agree to ~1e-12, so Newton counts match the f64 trajectory."""
    if solve_dtype not in ("f64", "f32_refine"):
        raise ValueError(f"unknown solve_dtype {solve_dtype!r}")
    dev = torch.device(device)
    f64 = torch.float64
    t0 = time.time()
    r, th, wq = _disk_quadrature(p)
    Vu, Gxu, Gyu = _basis_tables(p, r, th, weighted=True)
    Vp, _, _ = _basis_tables(p, r, th, weighted=False)
    t_tab = time.time() - t0

    x = r * np.cos(th)
    y = r * np.sin(th)
    phi = obstacle(np.stack([x, y]))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=f64, device=dev)

    # dense Galerkin operators, built on the device
    t0 = time.time()
    Vu_t, Vp_t, wq_t, phi_t = t(Vu), t(Vp), t(wq), t(phi)
    Gx_t, Gy_t = t(Gxu), t(Gyu)
    A = (Gx_t * wq_t[:, None]).T @ Gx_t + (Gy_t * wq_t[:, None]).T @ Gy_t
    Mup = (Vu_t * wq_t[:, None]).T @ Vp_t        # <Z_u, Z_psi>
    del Gx_t, Gy_t
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_ops = time.time() - t0
    nu, npsi = Vu.shape[1], Vp.shape[1]
    # <Z_psi, Z_u> block of the closed-form Jacobian: the exact transpose
    Mpu = Mup.T

    def resid(cu, cp, cp_k, alpha):
        psi_phys = Vp_t @ cp
        Fu = alpha * (A @ cu) + Mup @ (cp - cp_k)
        # latent row: <u - exp(psi) - phi, w> over the grid
        gap = Vu_t @ cu - torch.exp(psi_phys) - phi_t
        Fp = Vp_t.T @ (wq_t * gap)
        return torch.cat([Fu, Fp])

    def jac(cp, alpha):
        """Closed-form block Jacobian, one weighted matmul for the only
        state-dependent block:
          [alpha A, Mup; Vp^T diag(wq) Vu, -Vp^T diag(wq e^psi) Vp]."""
        e = torch.exp(Vp_t @ cp)
        Jpp = -(Vp_t * (wq_t * e)[:, None]).T @ Vp_t
        return torch.cat([torch.cat([alpha * A, Mup], dim=1),
                          torch.cat([Mpu, Jpp], dim=1)], dim=0)

    def solve_dense(J, b):
        if solve_dtype == "f32_refine":
            lu, piv = torch.linalg.lu_factor(J.to(torch.float32))

            def lu_solve(v):
                return torch.linalg.lu_solve(
                    lu, piv, v.to(torch.float32)[:, None])[:, 0].to(f64)

            dz = lu_solve(b)
            for _ in range(3):
                dz = dz + lu_solve(b - J @ dz)
            return dz
        return torch.linalg.solve(J, b)

    def newton_solve(cu, cp, cp_k, alpha):
        F0 = torch.linalg.norm(resid(cu, cp, cp_k, alpha))
        stop = newton_tol * F0

        def cond(state):
            it, _, _, nrm = state
            return (it < newton_max) & (nrm > stop)

        def body(state):
            it, cu, cp, _ = state
            F = resid(cu, cp, cp_k, alpha)
            dz = solve_dense(jac(cp, alpha), -F)
            cu2, cp2 = cu + dz[:nu], cp + dz[nu:]
            return (it + 1, cu2, cp2,
                    torch.linalg.norm(resid(cu2, cp2, cp_k, alpha)))

        it0 = torch.zeros((), dtype=torch.int64, device=dev)
        # chunk 1: a masked step would still factor its matrix
        it, cu, cp, _ = while_loop(cond, body, (it0, cu, cp, F0), chunk=1)
        return cu, cp, it

    cu = torch.zeros(nu, dtype=f64, device=dev)
    cp = torch.zeros(npsi, dtype=f64, device=dev)
    cp_k = torch.zeros(npsi, dtype=f64, device=dev)
    cu_prev = torch.zeros(nu, dtype=f64, device=dev)
    alpha = 1.0
    total = 0
    t0 = time.time()
    for k in range(100):
        try:
            alpha = min(max(1.5 ** (1.5**k) - alpha, 1.0), alpha_cap)
        except OverflowError:
            alpha = alpha_cap
        cu, cp, nits = newton_solve(cu, cp, cp_k,
                                    torch.tensor(alpha, dtype=f64,
                                                 device=dev))
        nits, inc = torch.stack([nits.to(f64),
                                 torch.linalg.norm(cu - cu_prev)]).tolist()
        total += int(nits)
        cp_k = cp
        if verbose:
            print(f"p={p} outer {k + 1} alpha={alpha:.3g} newton={int(nits)} "
                  f"inc={inc:.2e}")
        if inc < outer_tol:
            break
        cu_prev = cu
    if phases is not None:
        phases.update({"tabulate_s": round(t_tab, 2),
                       "operators_s": round(t_ops, 2),
                       "solve_s": round(time.time() - t0, 2)})

    cu_host = cu.cpu().numpy()

    def u_eval(rr, tt):
        Ve, _, _ = _basis_tables(p, np.atleast_1d(rr), np.atleast_1d(tt),
                                 weighted=True)
        return Ve @ cu_host

    return cu_host, total, u_eval


def spectral_p_sweep(ps=(8, 16, 24, 32, 40, 48), verbose=False,
                     solve_dtype: str = "f64", *,
                     device="cuda") -> SpectralObstacleResult:
    """Degree sweep (obstacle_spectral.jl:88-144): records Newton totals
    and successive sup-differences on a sample grid."""
    rs = np.linspace(0.0, 0.97, 40)
    ths = np.linspace(0.0, 2 * np.pi, 24, endpoint=False)
    RR, TT = [a.ravel() for a in np.meshgrid(rs, ths, indexing="ij")]
    prev = None
    res = SpectralObstacleResult([], [], [], None, [])
    for p in ps:
        ph: dict = {}
        cu, its, ev = spectral_obstacle_solve(p, verbose=verbose,
                                              solve_dtype=solve_dtype,
                                              phases=ph, device=device)
        res.phases.append(ph)
        vals = ev(RR, TT)
        res.degrees.append(p)
        res.newton_its.append(its)
        res.sup_errors.append(
            float(np.abs(vals - prev).max()) if prev is not None else np.nan)
        res.u_grid_fn = ev
        prev = vals
    return res
