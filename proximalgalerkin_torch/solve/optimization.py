"""Bound-constrained optimization baselines.

Self-contained replacements for the reference's external Fortran/C++
solvers behind the same `OptimizationProblem` protocol
(src/lvpp/optimization.py:13-36): a trust-region projected-Newton solver
standing in for GALAHAD `trb` (optimization.py:42-96) and a log-barrier
interior-point solver standing in for IPOPT (optimization.py:115-166).
Both consume objective / gradient / lower-triangular-Hessian callbacks so
the reference's QP problem classes (obstacle_ipopt_galahad.py:94-127)
port unchanged.

numpy/scipy only: a copy of the reference package's solve/optimization.py,
held to it bit for bit.
"""

from __future__ import annotations

import typing
from typing import Tuple

import numpy as np
import numpy.typing as npt
import scipy.sparse as sp
import scipy.sparse.linalg as spla

__all__ = ["OptimizationProblem", "trb_solver", "interior_point_solver",
           "galahad_solver", "ipopt_solver"]


class OptimizationProblem(typing.Protocol):
    """Protocol mirroring src/lvpp/optimization.py:13-36."""

    total_iteration_count: int

    def objective(self, x: npt.NDArray[np.float64]) -> np.float64: ...

    def gradient(self, x: npt.NDArray[np.float64]) -> npt.NDArray[np.float64]: ...

    def pure_hessian(self, x: npt.NDArray[np.float64]
                     ) -> npt.NDArray[np.float64]:
        """Lower-triangular Hessian values matching hessianstructure()."""
        ...

    def hessian(self, x, lagrange, obj_factor):
        return obj_factor * self.pure_hessian(x)

    def hessianstructure(self) -> tuple[npt.NDArray[np.int32],
                                        npt.NDArray[np.int32]]: ...


def _hessian_csr(problem: OptimizationProblem, x: np.ndarray) -> sp.csr_matrix:
    rows, cols = problem.hessianstructure()
    vals = np.asarray(problem.pure_hessian(x), dtype=np.float64)
    n = len(x)
    H = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    # symmetrize from lower triangle
    D = sp.diags(H.diagonal())
    return (H + H.T - D).tocsr()


def trb_solver(problem: OptimizationProblem,
               x_init: np.ndarray,
               bounds: Tuple[np.ndarray, np.ndarray],
               log_level: int = 0,
               use_hessian: bool = True,
               max_iter: int = 100,
               tol: float = 1e-6) -> Tuple[np.ndarray, int]:
    """Trust-region projected-Newton for min f(x) s.t. lb <= x <= ub.

    Same signature/return as the reference's galahad_solver
    (optimization.py:42-96): returns (x, iterations). Convergence test is
    the relative projected-gradient norm (`stop_pg_relative`)."""
    lb, ub = np.asarray(bounds[0], float), np.asarray(bounds[1], float)
    x = np.clip(np.asarray(x_init, float), lb, ub)
    n = len(x)
    radius = 1.0

    def proj_grad_norm(x, g):
        return np.linalg.norm(x - np.clip(x - g, lb, ub))

    g = np.asarray(problem.gradient(x), float)
    pg0 = max(proj_grad_norm(x, g), 1e-300)
    it = 0
    for it in range(1, max_iter + 1):
        g = np.asarray(problem.gradient(x), float)
        pg = proj_grad_norm(x, g)
        if pg <= tol * pg0:
            break
        fx = float(problem.objective(x))

        # free/active split at the current iterate
        eps_a = 1e-12
        active = ((x <= lb + eps_a) & (g > 0)) | ((x >= ub - eps_a) & (g < 0))
        free = ~active
        d = np.zeros(n)
        if use_hessian and free.any():
            H = _hessian_csr(problem, x)
            Hff = H[free][:, free].tocsc()
            try:
                d[free] = spla.splu(
                    Hff + 1e-12 * sp.identity(Hff.shape[0], format="csc")
                ).solve(-g[free])
            except RuntimeError:
                d[free] = -g[free]
            # fall back to steepest descent if not a descent direction
            if g @ d >= 0:
                d = np.where(free, -g, 0.0)
        else:
            d = np.where(free, -g, 0.0)

        # trust-region step control with projection onto the box
        accepted = False
        for _ in range(30):
            nd = np.linalg.norm(d)
            step = d if nd <= radius else d * (radius / nd)
            x_trial = np.clip(x + step, lb, ub)
            f_trial = float(problem.objective(x_trial))
            pred = -(g @ (x_trial - x))
            if f_trial < fx - 1e-4 * max(pred, 0.0) or f_trial < fx:
                rho_good = f_trial < fx - 0.5 * max(pred, 0.0)
                x = x_trial
                radius = min(radius * (2.0 if rho_good else 1.0), 1e6)
                accepted = True
                break
            radius *= 0.25
            if radius < 1e-14:
                break
        if not accepted:
            break
        if log_level > 0:
            print(f"  trb it {it}: f {f_trial:.6e} pg {pg:.3e} "
                  f"radius {radius:.1e}")
    return x, it


def interior_point_solver(problem: OptimizationProblem,
                          x_init: np.ndarray,
                          bounds: Tuple[np.ndarray, np.ndarray],
                          log_level: int = 0,
                          max_iter: int = 100,
                          tol: float = 1e-6,
                          activate_hessian: bool = True
                          ) -> Tuple[np.ndarray, int]:
    """Primal log-barrier interior-point for box constraints — the IPOPT
    stand-in (optimization.py:115-166). Infinite bounds are skipped.

    Returns (x, total Newton iterations)."""
    lb, ub = np.asarray(bounds[0], float), np.asarray(bounds[1], float)
    has_lb, has_ub = np.isfinite(lb), np.isfinite(ub)
    x = np.asarray(x_init, float).copy()
    # strictly feasible start
    pad = 1e-3 * (1.0 + np.abs(x))
    x = np.where(has_lb, np.maximum(x, lb + pad), x)
    x = np.where(has_ub, np.minimum(x, ub - pad), x)

    mu = 1.0
    total_its = 0
    n = len(x)
    g0 = max(np.linalg.norm(np.asarray(problem.gradient(x), float)), 1.0)
    while mu > tol * 1e-2 and total_its < max_iter:
        for _ in range(20):
            g = np.asarray(problem.gradient(x), float)
            r = g.copy()
            r -= np.where(has_lb, mu / np.maximum(x - lb, 1e-300), 0.0)
            r += np.where(has_ub, mu / np.maximum(ub - x, 1e-300), 0.0)
            if np.linalg.norm(r) <= tol * g0 + 10 * mu:
                break
            bdiag = (np.where(has_lb, mu / np.maximum(x - lb, 1e-300) ** 2, 0.0)
                     + np.where(has_ub, mu / np.maximum(ub - x, 1e-300) ** 2, 0.0))
            if activate_hessian:
                H = _hessian_csr(problem, x) + sp.diags(bdiag)
            else:
                H = sp.diags(bdiag + 1.0)
            try:
                dx = spla.splu(H.tocsc()).solve(-r)
            except RuntimeError:
                dx = -r
            # fraction-to-boundary
            t = 1.0
            neg = dx < 0
            pos = dx > 0
            with np.errstate(divide="ignore", invalid="ignore"):
                tl = np.where(has_lb & neg, (lb - x) / dx, np.inf)
                tu = np.where(has_ub & pos, (ub - x) / dx, np.inf)
            t = min(1.0, 0.995 * min(np.min(tl), np.min(tu)))
            x = x + t * dx
            total_its += 1
            if total_its >= max_iter:
                break
        if log_level > 0:
            print(f"  ip mu {mu:.2e} its {total_its}")
        mu *= 0.1
    return x, total_its


# Aliases keeping the reference's public function names so downstream code
# can switch frameworks without renaming (optimization.py:42,115).
def galahad_solver(problem, x_init, bounds, log_level=1, use_hessian=True,
                   max_iter=100, tol=1e-6):
    return trb_solver(problem, x_init, bounds, log_level=log_level,
                      use_hessian=use_hessian, max_iter=max_iter, tol=tol)


def ipopt_solver(problem, x_init, bounds, log_level=0, max_iter=100,
                 tol=1e-6, activate_hessian=True):
    x, _ = interior_point_solver(problem, x_init, bounds,
                                 log_level=log_level, max_iter=max_iter,
                                 tol=tol, activate_hessian=activate_hessian)
    return x
