"""Variational-inequality Newton baseline (PETSc `vinewtonssls`/`rsls`
stand-in; the reference's SNES-VI comparator, obstacle_snes.py:36-115 and
compare_all.py:150-161), in PyTorch. The port of the reference package's
solve/vi.py.

Reduced-space semismooth Newton with active-set projection: at each step
the active set (bound reached with residual pushing outward) is frozen to
its bound and Newton acts on the inactive block. Convergence is measured
on the natural (min/median) map residual, the standard VI merit. The
residuals and the Jacobian's element matrices come from the
NonlinearProblem on its device; the active-set logic and the sparse LU
(scipy splu) run on the host."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse.linalg as spla
import torch

from ..core.config import SolverOptions
from ..core.reasons import ConvergedReason
from .nonlinear import NonlinearProblem


def vi_solve(problem: NonlinearProblem,
             x0,
             lower: np.ndarray,
             upper: Optional[np.ndarray] = None,
             options: Optional[dict] = None
             ) -> Tuple[torch.Tensor, int, int]:
    """Solve F(x) = 0 subject to lower <= x <= upper.

    Returns (x as a tensor on the problem's device, converged_reason,
    iterations) with SNES-compatible codes.
    """
    opts = SolverOptions(options or {})
    atol = float(opts.opt("snes_atol", 1e-8))
    rtol = float(opts.opt("snes_rtol", 1e-8))
    max_it = int(opts.opt("snes_max_it", 100))
    monitor = bool(opts.opt("snes_monitor", False))

    lb = np.asarray(lower, float)
    ub = (np.full_like(lb, np.inf) if upper is None
          else np.asarray(upper, float))

    def on_device(a):
        return problem.form._as(a)

    def residual(x):
        return problem.residual(on_device(x)).cpu().numpy()

    x = np.clip(problem.set_bc(x0).cpu().numpy(), lb, ub)

    def natural_residual(x, F):
        # r_i = x_i - median(lb_i, x_i - F_i, ub_i)
        return x - np.minimum(np.maximum(x - F, lb), ub)

    F = residual(x)
    r = natural_residual(x, F)
    r0 = max(np.linalg.norm(r), 1e-300)
    reason = ConvergedReason.DIVERGED_MAX_IT
    it = 0
    for it in range(1, max_it + 1):
        rn = np.linalg.norm(r)
        if monitor:
            print(f"  {it - 1:3d} SNES VI natural norm {rn:.12e}")
        if rn < atol or rn < rtol * r0:
            reason = (ConvergedReason.CONVERGED_FNORM_ABS if rn < atol
                      else ConvergedReason.CONVERGED_FNORM_RELATIVE)
            break

        eps_a = 1e-10
        active = (((x <= lb + eps_a) & (F > 0))
                  | ((x >= ub - eps_a) & (F < 0)))
        J = problem.jacobian_scipy(on_device(x)).tolil()
        aidx = np.flatnonzero(active)
        if len(aidx):
            J[aidx, :] = 0.0
            J[aidx, aidx] = 1.0
        rhs = -F.copy()
        rhs[aidx] = np.where(x[aidx] <= lb[aidx] + eps_a,
                             lb[aidx] - x[aidx], ub[aidx] - x[aidx])
        dx = spla.splu(J.tocsc()).solve(rhs)
        x = np.clip(x + dx, lb, ub)
        F = residual(x)
        if not np.all(np.isfinite(F)):
            reason = ConvergedReason.DIVERGED_FNORM_NAN
            break
        r = natural_residual(x, F)
    return on_device(x), int(reason), it - 1
