"""Example 08 — intersecting (simultaneous obstacle + gradient)
constraints, in PyTorch.

The port of the reference package's models/intersecting.py
(examples/08_intersecting_constraints/intersecting_constraints_dolfinx.py):
1D interval mesh (1001 cells, P1), 3-field (u, psi0, psi) with u >= phi0
via exp(psi0) and |u'| <= phi via the Hellinger map (:16-60), continuation
over the gradient bound phis = [3, 2, 1, 0.5, 0.1, 0.01] (:108), and the
adaptive-alpha retry state machine (x2 if Newton <= 4, /2 if >= 10,
halve+rollback on failure, NFAIL_MAX = 50; :120-174) — driven here by
LVPPSolver(adaptive=True).

Residual:
  v-row:  alpha (u' v' + c v) + (psi0 - psi0_iter) v + (psi - psi_iter) v'
  w0-row: (u - exp(psi0) - phi0) w0
  w-row:  (u' - phi psi / sqrt(1 + psi^2)) w
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer, rank_print
from ..mesh.generation import unit_interval_mesh
from ..solve import AlphaScheduler, LVPPSolver, NonlinearProblem
from ..spaces import DirichletBC, FunctionSpace, MixedSpace


def smooth_bump(x: np.ndarray, l: float = 0.2, r: float = 0.8) -> np.ndarray:
    """The reference's smooth obstacle (:39-41)."""
    inside = (x > l) & (x < r)
    xs = np.clip(x, l + 1e-12, r - 1e-12)
    val = np.exp(-1.0 / (10.0 * (xs - l) * (r - xs)))
    norm = np.exp(-1.0 / (10.0 * (0.5 - l) * (r - 0.5)))
    return np.where(inside, val / norm, 0.0)


@dataclass
class IntersectingResult:
    u: np.ndarray
    lvpp_iterations: List[int]
    newton_iterations: List[int]
    phis: List[float]
    converged: List[bool]


def solve_intersecting(
    n_cells: int = 1001,
    phis: Sequence[float] = (3.0, 2.0, 1.0, 0.5, 0.1, 0.01),
    inner_bound: float = 100.0,
    tol: float = 1e-4,
    nfail_max: int = 50,
    c_load: float = 0.0,
    solver_options: Optional[dict] = None,
    verbose: bool = True,
    *,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> IntersectingResult:
    """timer: a PhaseTimer that every continuation step's Newton solver
    adds to (residual, assembly, host_transfer, csr, lu_factor, ...)."""
    device = torch.device(device)
    f64 = torch.float64
    mesh = unit_interval_mesh(n_cells)
    V = FunctionSpace.create(mesh, 1)
    Q = FunctionSpace.create(mesh, 1, value_size=1)
    space = MixedSpace([("u", V), ("psi0", V), ("psi", Q)])

    def residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        phic = consts["phic"]
        psi = u["psi"]
        xx = x[0]
        # gradient bound: phic outside (0.2, 0.8], large inside (:44)
        phi = torch.where(xx <= 0.2, phic,
                          torch.where(xx > 0.8, phic, inner_bound))
        denom = torch.sqrt(1.0 + psi * psi)
        a1_u = alpha * gu["u"] + psi - c["psi_iter"]
        a0_u = alpha * c_load + u["psi0"] - c["psi0_iter"]
        a0_p0 = u["u"] - torch.exp(u["psi0"]) - c["phi0"]
        a0_p = gu["u"] - phi * psi / denom
        return {"u": (a0_u, a1_u), "psi0": (a0_p0, None),
                "psi": (a0_p, None)}

    form = VolumeForm(space, residual, quadrature_degree=6,
                      coeff_spaces={"psi0_iter": V, "psi_iter": Q,
                                    "u_iter": V}, device=device)
    phi0_q = torch.as_tensor(
        form.interpolate_to_quadrature(lambda x: smooth_bump(x[0])),
        dtype=f64, device=device)

    bcs = [DirichletBC.from_marker("u", V, value=0.0)]
    problem = NonlinearProblem(
        form, bcs, coeffs={"phi0": phi0_q},
        consts={"alpha": torch.tensor(1.0, dtype=f64, device=device),
                "phic": torch.tensor(phis[0], dtype=f64, device=device)})

    u_sl = space.slice_of("u")
    p0_sl = space.slice_of("psi0")
    p_sl = space.slice_of("psi")

    def prev_coeffs(x_k):
        return {"psi0_iter": x_k[p0_sl], "psi_iter": x_k[p_sl],
                "u_iter": x_k[u_sl]}

    l2_fn = form.make_functional(
        lambda x, u, gu, c, gc, k: (u["u"] - c["u_iter"]) ** 2)

    def increment(x, x_k):
        coeffs = {"phi0": phi0_q, **prev_coeffs(x_k)}
        return float(np.sqrt(max(float(l2_fn(x, coeffs, {})), 0.0)))

    opts = {"snes_atol": 1e-6, "snes_rtol": 1e-6, "snes_stol": 1e-14,
            "snes_linesearch_type": "l2", "snes_max_it": 50,
            "ksp_type": "preonly", "pc_type": "lu"}
    opts.update(solver_options or {})

    lvpp_its: List[int] = []
    newton_its: List[int] = []
    converged: List[bool] = []
    x = torch.zeros(space.num_dofs, dtype=f64, device=device)
    for phi_ in phis:
        if verbose:
            rank_print(f"Solving for phi = {phi_}")
        problem.update(consts={"phic": torch.tensor(phi_, dtype=f64,
                                                    device=device)})
        solver = LVPPSolver(
            problem,
            newton_options=SolverOptions(opts),
            alpha=AlphaScheduler(scheme="constant", C=1.0, alpha_max=np.inf),
            prev_coeffs=prev_coeffs,
            increment=increment,
            tol=tol,
            max_iterations=200,
            adaptive=True,
            adaptive_grow=2.0, adaptive_shrink=2.0,
            grow_below_its=4, shrink_above_its=10,
            nfail_max=nfail_max,
            verbose=verbose,
            timer=timer,
        )
        res = solver.solve(x)
        x = res.x
        lvpp_its.append(res.iterations)
        newton_its.append(res.total_newton)
        converged.append(res.converged)

    return IntersectingResult(u=x[u_sl].cpu().numpy(),
                              lvpp_iterations=lvpp_its,
                              newton_iterations=newton_its,
                              phis=list(phis), converged=converged)
