"""Example 09 — eikonal equation |grad u| = 1 on a manifold, in PyTorch.

The port of the reference package's models/eikonal.py
(examples/09_eikonal/eikonal_dolfinx.py and the MFEM ex40 block
formulation): maximize ∫u subject to |grad u| <= 1 in the div-form LVPP
discretization with a Taylor–Hood-like mixed space (u: P1 scalar, psi:
P2 vector with gdim components), on the Möbius strip manifold (gdim = 3,
tdim = 2; mesh/manifolds.py) by default. Residual (:52-58):

  v-row:   (div psi - div psi0 + alpha f) v
  tau-row: u div(tau) + phi psi/sqrt(1+|psi|^2) . tau

(u div(tau) enters through the a1 slot as u * I). No boundary conditions
(:78). alpha = min(2^i, 10) (:152); the outer loop exits when the u
increment drops below 5*tol with tol = 1e-5 (:63,173); Newton with the l2
line search at tol 1e-5. Asking for ksp_type='minres' without a pc_type
selects the block-Schur preconditioner with block0 = psi (la/schur.py, the
ex40.cpp:261-281 recipe).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer, rank_print
from ..mesh.manifolds import mobius_strip
from ..mesh.mesh import Mesh
from ..solve import NonlinearProblem
from ..solve.newton import NewtonSolver
from ..spaces import FunctionSpace, MixedSpace


@dataclass
class EikonalResult:
    u: np.ndarray
    lvpp_iterations: int
    newton_iterations: List[int]
    converged: bool

    @property
    def total_newton(self):
        return int(sum(self.newton_iterations))


def solve_eikonal(
    mesh: Optional[Mesh] = None,
    ns: int = 48, nt: int = 6,
    f: float = 1.0,
    phi: float = 1.0,
    tol: float = 1e-5,
    alpha_cap: float = 10.0,
    max_iterations: int = 100,
    solver_options: Optional[dict] = None,
    verbose: bool = True,
    *,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> EikonalResult:
    """timer: a PhaseTimer that the Newton solver adds to (residual,
    assembly, lu_factor or linear_solve_krylov, ...)."""
    device = torch.device(device)
    f64 = torch.float64
    mesh = mesh if mesh is not None else mobius_strip(ns, nt)
    gdim = mesh.gdim
    U = FunctionSpace.create(mesh, 1)
    Q = FunctionSpace.create(mesh, 2, value_size=gdim)
    space = MixedSpace([("u", U), ("psi", Q)])

    eye = torch.eye(gdim, dtype=f64, device=device)

    def residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        psi = u["psi"]
        div_psi = torch.trace(gu["psi"])
        div_psi0 = torch.trace(gc["psi0"])
        a0_u = div_psi - div_psi0 + alpha * f
        denom = torch.sqrt(1.0 + torch.dot(psi, psi))
        a0_p = phi * psi / denom
        a1_p = u["u"] * eye          # u * div(tau) term
        return {"u": (a0_u, None), "psi": (a0_p, a1_p)}

    form = VolumeForm(space, residual, quadrature_degree=5,
                      coeff_spaces={"psi0": Q, "u0": U}, device=device)
    problem = NonlinearProblem(
        form, [], consts={"alpha": torch.tensor(1.0, dtype=f64,
                                                device=device)})

    opts = {"snes_linesearch_type": "l2", "snes_rtol": tol,
            "snes_atol": tol, "snes_stol": tol, "snes_max_it": 100,
            "ksp_type": "preonly", "pc_type": "lu"}
    opts.update(solver_options or {})
    # iterative default: block-Schur MINRES with block0 = the latent psi
    # (its diagonal is the Hellinger-map derivative mass matrix, the
    # invertible block), whenever minres is asked for without a
    # preconditioner
    if opts.get("ksp_type") == "minres" and "pc_type" not in (
            solver_options or {}):
        opts.update({"pc_type": "schur", "mat_type": "ell",
                     "pc_schur_field0": "psi"})
    newton = NewtonSolver(problem, SolverOptions(opts), timer=timer)

    l2_fn = form.make_functional(
        lambda x, u, gu, c, gc, k: (u["u"] - c["u0"]) ** 2)

    u_sl = space.slice_of("u")
    psi_sl = space.slice_of("psi")

    x = torch.zeros(space.num_dofs, dtype=f64, device=device)
    x_prev = x
    newton_its: List[int] = []
    converged = False
    it = 0
    for i in range(max_iterations):
        a = min(2.0**i, alpha_cap)
        problem.update(coeffs={"psi0": x_prev[psi_sl], "u0": x_prev[u_sl]},
                       consts={"alpha": torch.tensor(a, dtype=f64,
                                                     device=device)})
        res = newton.solve(x)
        if not res.converged:
            rank_print(f"Newton failed: {res.reason.name}")
            break
        x = res.x
        it = i + 1
        newton_its.append(res.iterations)
        diff = float(np.sqrt(max(float(l2_fn(
            x, dict(problem.coeffs), {})), 0.0)))
        if verbose:
            rank_print(f"it={it} alpha={a} newton={res.iterations} "
                       f"|du|={diff:.3e}")
        if diff < 5 * tol:
            converged = True
            break
        x_prev = x

    return EikonalResult(u=x[u_sl].cpu().numpy(), lvpp_iterations=it,
                         newton_iterations=newton_its, converged=converged)
