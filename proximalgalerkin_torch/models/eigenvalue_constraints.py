"""Example 07 — eigenvalue-constrained Landau–de Gennes Q-tensor model, in
PyTorch.

The port of the reference package's models/eigenvalue_constraints.py
(examples/07_eigenvalue_constraints/eigenvalue_constraints_dolfinx.py):
2x2 trace-free symmetric Q-tensor parametrized by (q1, q2) (:49-54),
eigenvalue bounds |lambda(Q)| <= 1/2 via the matrix-tanh latent map
0.5*tanh(Psi/2) (:32-33,78-84) in the closed traceless form
tanh(M) = tanh(|m|)/|m| M (forms/maps.py), energy
E = 1/2|grad Q|^2 + A/2 tr(Q^2) + C/4 tr(Q^2)^2 (:72-77, with
torch.func.grad of the pointwise density replacing ufl.derivative; the
form's jacfwd differentiates through it, forward over reverse), Robinson
et al. ramp boundary data (:93-122), quadrature degree 20 (:70), and the
adaptive-alpha retry machine (:168-227), terminating at
||Q_k - Q_{k-1}||_L2 < 1e-10 (:215).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.func import grad

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer
from ..forms.maps import tanhm_sym2_traceless
from ..mesh.generation import unit_square_mesh
from ..solve import AlphaScheduler, LVPPResult, LVPPSolver, NonlinearProblem
from ..spaces import DirichletBC, FunctionSpace, MixedSpace


def _ramp(z: np.ndarray, d: float = 0.06) -> np.ndarray:
    """Boundary ramp T (:102-112)."""
    out = np.ones_like(z)
    out = np.where(z < d, z / d, out)
    out = np.where(z > 1 - d, (1 - z) / d, out)
    return out


def _boundary_g(x: np.ndarray, d: float = 0.06,
                theta_tb: float = 0.0, theta_lr: float = np.pi / 2):
    """(g_xx, g_xy) Dirichlet data (:93-122)."""
    top_bottom = np.isclose(x[1], 0) | np.isclose(x[1], 1)
    left_right = np.isclose(x[0], 0) | np.isclose(x[0], 1)
    s = _ramp(x[1], d) * left_right + _ramp(x[0], d) * top_bottom
    tht = theta_lr * left_right + theta_tb * top_bottom
    return 0.5 * s * np.cos(2 * tht), 0.5 * s * np.sin(2 * tht)


@dataclass
class EigenvalueResult:
    q1: np.ndarray
    q2: np.ndarray
    lvpp: LVPPResult

    def eigenvalue_range(self):
        """Min/max eigenvalues of Q over dofs (reference post-processing
        :251-259): traceless sym 2x2 has eigenvalues ±sqrt(q1^2+q2^2)."""
        lam = np.sqrt(self.q1**2 + self.q2**2)
        return -lam.max(), lam.max()


def solve_eigenvalue_constraints(
    N: int = 100,
    degree: int = 3,
    A: float = 1.0,
    C: float = 4.0,
    quadrature_degree: int = 20,
    tol: float = 1e-10,
    max_lvpp: int = 100,
    nfail_max: int = 50,
    solver_options: Optional[dict] = None,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    *,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> EigenvalueResult:
    """checkpoint_path: LVPPCheckpoint written every outer iteration and
    resumed from on entry if present (the reference's file format, so a
    checkpoint of either package resumes in the other). timer: a
    PhaseTimer for the Newton solver's phases."""
    device = torch.device(device)
    mesh = unit_square_mesh(N, N, cell_type="quadrilateral")
    V = FunctionSpace.create(mesh, degree)
    space = MixedSpace([("q1", V), ("q2", V), ("psi1", V), ("psi2", V)])

    def energy_density(vals, grads):
        q1, q2 = vals["q1"], vals["q2"]
        g1, g2 = grads["q1"], grads["q2"]
        trQ2 = 2.0 * (q1 * q1 + q2 * q2)
        return ((g1 * g1).sum(-1) + (g2 * g2).sum(-1)
                + 0.5 * A * trQ2 + 0.25 * C * trQ2 * trQ2)

    def residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        # alpha * E'(z): the gradient of the pointwise energy density with
        # respect to values and gradients (replaces ufl.derivative, :80)
        de_dv, de_dg = grad(lambda s: energy_density(s[0], s[1]))(
            ({"q1": u["q1"], "q2": u["q2"]},
             {"q1": gu["q1"], "q2": gu["q2"]}))
        t1, t2 = tanhm_sym2_traceless(0.5 * u["psi1"], 0.5 * u["psi2"])
        a0_q1 = alpha * de_dv["q1"] + 2.0 * (u["psi1"] - c["psi1_i"])
        a0_q2 = alpha * de_dv["q2"] + 2.0 * (u["psi2"] - c["psi2_i"])
        a1_q1 = alpha * de_dg["q1"]
        a1_q2 = alpha * de_dg["q2"]
        a0_p1 = 2.0 * (u["q1"] - 0.5 * t1)
        a0_p2 = 2.0 * (u["q2"] - 0.5 * t2)
        return {"q1": (a0_q1, a1_q1), "q2": (a0_q2, a1_q2),
                "psi1": (a0_p1, None), "psi2": (a0_p2, None)}

    form = VolumeForm(space, residual, quadrature_degree,
                      coeff_spaces={"psi1_i": V, "psi2_i": V,
                                    "q1_i": V, "q2_i": V}, device=device)

    bcs = [
        DirichletBC.from_marker("q1", V, value=lambda x: _boundary_g(x)[0]),
        DirichletBC.from_marker("q2", V, value=lambda x: _boundary_g(x)[1]),
    ]
    problem = NonlinearProblem(form, bcs, consts={"alpha": torch.tensor(
        1.0, dtype=torch.float64, device=device)})

    sls = {n: space.slice_of(n) for n in space.names}

    def prev_coeffs(x_k):
        return {"psi1_i": x_k[sls["psi1"]], "psi2_i": x_k[sls["psi2"]],
                "q1_i": x_k[sls["q1"]], "q2_i": x_k[sls["q2"]]}

    l2_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        2.0 * ((u["q1"] - c["q1_i"]) ** 2 + (u["q2"] - c["q2_i"]) ** 2))

    def increment(x, x_k):
        return float(np.sqrt(max(float(l2_fn(x, prev_coeffs(x_k), {})), 0.0)))

    opts = {"snes_linesearch_type": "l2", "snes_rtol": 1e-8,
            "snes_atol": 1e-50, "snes_max_it": 50,
            "ksp_type": "preonly", "pc_type": "lu"}
    opts.update(solver_options or {})

    solver = LVPPSolver(
        problem,
        newton_options=SolverOptions(opts),
        alpha=AlphaScheduler(scheme="constant", C=1.0, alpha_max=np.inf),
        prev_coeffs=prev_coeffs,
        increment=increment,
        tol=tol,
        max_iterations=max_lvpp,
        adaptive=True, adaptive_grow=2.0, adaptive_shrink=2.0,
        grow_below_its=4, shrink_above_its=10, nfail_max=nfail_max,
        verbose=verbose,
        checkpoint_path=checkpoint_path,
        timer=timer,
    )
    resume = None
    if checkpoint_path is not None and Path(checkpoint_path).exists():
        from ..utils.checkpoint import LVPPCheckpoint
        resume = LVPPCheckpoint.load(checkpoint_path)
        if verbose:
            print(f"Resuming eigenvalue LVPP at iteration "
                  f"{resume.iteration}")
    res = solver.solve(space.zeros(), resume=resume)
    return EigenvalueResult(q1=res.x[sls["q1"]].cpu().numpy(),
                            q2=res.x[sls["q2"]].cpu().numpy(),
                            lvpp=res)
