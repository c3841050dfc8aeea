"""Example 05 — thermoforming quasi-variational inequality (QVI), in
PyTorch.

The port of the reference package's models/thermoforming.py
(examples/05_obstacle_type_qvi/thermoforming_dolfinx.py): the obstacle
depends on the solution through a temperature PDE. Mixed P1 (u, T, psi);
piecewise-linear mollifier g (:42-48, the branch-free clip form),
constraint map exp(-psi) (:66), stabilized Jacobian
J = d(F - eps/alpha <grad psi, grad w>) (:70-71), alpha *= 4 per outer
iteration capped at 2^14 (:157-158), H1-increment termination at 1e-9
(:101,141-151), Newton with bt linesearch and atol/rtol 1e-5 (:103-113).

Residual:
  u-row:   alpha <grad u, grad v> + <psi - psi_prev - alpha f, v>
  T-row:   <grad T, grad q> + <beta T - g(exp(-psi)), q>
  psi-row: <u + exp(-psi) - (Phi0 + xi T), w>

clip is written as minimum(maximum(s, lo), hi) with tensor bounds: its
derivative at a tie is then 1/2, as the reference's (torch.clamp would
give 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer, rank_print
from ..core.reasons import NotConvergedError
from ..mesh.generation import unit_square_mesh
from ..solve import NonlinearProblem
from ..solve.newton import NewtonSolver
from ..spaces import DirichletBC, FunctionSpace, MixedSpace


def clip(s, lo: float, hi: float):
    """jnp.clip with the reference's derivative at the bounds (1/2 at a
    tie, from torch.maximum/torch.minimum against tensors)."""
    return torch.minimum(torch.maximum(s, torch.full_like(s, lo)),
                         torch.full_like(s, hi))


def mollifier(s, q_bound: float):
    """g(s) = conditional(s<0, 1, conditional(s<q, 1-s/q, 0)) == clip form."""
    return clip(1.0 - s / q_bound, 0.0, 1.0)


def mould0(x):
    return 1.0 - 2.0 * torch.maximum(torch.abs(x[0] - 0.5),
                                     torch.abs(x[1] - 0.5))


def xi(x):
    return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])


@dataclass
class ThermoformingResult:
    u: np.ndarray
    T: np.ndarray
    psi: np.ndarray
    mould: np.ndarray          # Phi0 + xi*T at dof points
    lvpp_iterations: int
    newton_iterations: List[int]
    converged: bool

    @property
    def total_newton(self) -> int:
        return int(sum(self.newton_iterations))


def solve_thermoforming(
    M: int = 150,
    q_bound: float = 0.01,
    beta: float = 1.0,
    f: float = 25.0,
    alpha_0: float = 2.0 ** (-6),
    alpha_factor: float = 4.0,
    alpha_max: float = 2.0 ** 14,
    termination_tol: float = 1e-9,
    max_lvpp_iterations: int = 100,
    eps_stab: float = 1e-10,
    solver_options: Optional[dict] = None,
    verbose: bool = True,
    *,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> ThermoformingResult:
    device = torch.device(device)
    f64 = torch.float64
    mesh = unit_square_mesh(M, M)
    V = FunctionSpace.create(mesh, 1)
    space = MixedSpace([("u", V), ("T", V), ("psi", V)])

    def residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        # overflow guard: Newton can overshoot psi far negative before the
        # linesearch recovers; exp stays finite and the eps-stabilized
        # Jacobian (:70-71) keeps the clipped rows nonsingular
        expm = torch.exp(-clip(u["psi"], -45.0, 45.0))
        a0_u = u["psi"] - c["psi_prev"] - alpha * f
        a1_u = alpha * gu["u"]
        a0_T = beta * u["T"] - mollifier(expm, q_bound)
        a1_T = gu["T"]
        a0_p = u["u"] + expm - (mould0(x) + xi(x) * u["T"])
        return {"u": (a0_u, a1_u), "T": (a0_T, a1_T), "psi": (a0_p, None)}

    def jac_residual(x, u, gu, c, gc, consts):
        # F minus the eps/alpha grad(psi).grad(w) stabilization (:70-71)
        out = residual(x, u, gu, c, gc, consts)
        a0_p, _ = out["psi"]
        out["psi"] = (a0_p, -(eps_stab / consts["alpha"]) * gu["psi"])
        return out

    form = VolumeForm(space, residual, quadrature_degree=3,
                      jacobian_fn=jac_residual,
                      coeff_spaces={"psi_prev": V, "u_prev": V},
                      device=device)
    bcs = [DirichletBC.from_marker("u", V, value=0.0)]
    problem = NonlinearProblem(form, bcs, consts={"alpha": torch.tensor(
        alpha_0, dtype=f64, device=device)})

    opts = {"snes_atol": 1e-5, "snes_rtol": 1e-5,
            "snes_stol": 10 * np.finfo(np.float64).eps,
            "snes_linesearch_type": "bt", "snes_max_it": 50,
            "ksp_type": "preonly", "pc_type": "lu"}
    opts.update(solver_options or {})
    newton = NewtonSolver(problem, SolverOptions(opts), timer=timer)

    h1_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        (u["u"] - c["u_prev"]) ** 2
        + ((gu["u"] - gc["u_prev"]) ** 2).sum(-1))

    u_sl = space.slice_of("u")
    T_sl = space.slice_of("T")
    psi_sl = space.slice_of("psi")

    x = torch.zeros(space.num_dofs, dtype=f64, device=device)
    x[T_sl] = 1.0               # initial guess T = 1 (:118)
    x_prev = torch.zeros_like(x)

    alpha = alpha_0
    newton_its: List[int] = []
    converged = False
    nfail = 0
    i = 0
    for i in range(1, max_lvpp_iterations + 1):
        if verbose:
            rank_print(f"LVPP iteration: {i} Alpha: {alpha}")
        problem.update(coeffs={"psi_prev": x_prev[psi_sl],
                               "u_prev": x_prev[u_sl]},
                       consts={"alpha": torch.tensor(alpha, dtype=f64,
                                                     device=device)})
        res = newton.solve(x)
        if not res.converged:
            # LVPP failure-retry (the fracture/eigenvalue pattern,
            # fracture_dolfinx.py:243-264): halve alpha, roll back, retry
            nfail += 1
            if nfail > 20:
                raise NotConvergedError(
                    res.reason, f"Solver did not converge {res.reason}")
            alpha = alpha / 2.0
            x = x_prev
            continue
        x = res.x
        newton_its.append(res.iterations)
        coeffs = dict(problem.coeffs)
        diff = float(np.sqrt(max(float(h1_fn(x, coeffs, {})), 0.0)))
        if verbose:
            rank_print(f"LVPP iteration {i}, Newton {res.iterations} "
                       f"||u-u_prev||_H1={diff:.3e}")
        if diff < termination_tol:
            converged = True
            break
        x_prev = x
        alpha = min(alpha * alpha_factor, alpha_max)

    pts = V.dof_points
    Tval = x[T_sl].cpu().numpy()
    mould = (np.asarray(1 - 2 * np.maximum(np.abs(pts[:, 0] - 0.5),
                                           np.abs(pts[:, 1] - 0.5)))
             + np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1]) * Tval)
    return ThermoformingResult(
        u=x[u_sl].cpu().numpy(), T=Tval, psi=x[psi_sl].cpu().numpy(),
        mould=mould, lvpp_iterations=i, newton_iterations=newton_its,
        converged=converged)
