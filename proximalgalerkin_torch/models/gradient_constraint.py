"""Example 06 — gradient-norm constraint (elastoplastic torsion), in
PyTorch.

The port of the reference package's models/gradient_constraint.py
(examples/06_gradient_constraints/gradient_constraint_dolfinx.py):
|grad u| <= phi(x) enforced by the Hellinger latent map
phi * psi / sqrt(1 + |psi|^2) with a *vector* latent field of degree p-1
(:40-45,106-107; DG0 for p = 1). Residual (:101-108):

  F_u(v)   = alpha <grad u, grad v> + <psi - psi_0, grad v> - alpha <f, v>
  F_psi(w) = <grad u - phi psi / sqrt(1 + |psi|^2), w>

Includes the optional Poisson warm start (:72-96), the DG0 active-set
indicators (:134-146), linear/doubling alpha schemes (:173-178), and the
L2-increment stopping rule (:168-169,201).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer
from ..mesh.generation import unit_square_mesh
from ..mesh.mesh import Mesh
from ..solve import AlphaScheduler, LVPPResult, LVPPSolver, NonlinearProblem
from ..solve.newton import NewtonSolver
from ..spaces import DirichletBC, FunctionSpace, MixedSpace


def default_phi(x: np.ndarray) -> np.ndarray:
    """Reference default gradient bound (gradient_constraint_dolfinx.py:289)."""
    return 0.1 + 0.2 * x[0] + 0.4 * x[1]


def default_f(x: np.ndarray) -> np.ndarray:
    """Reference default forcing (gradient_constraint_dolfinx.py:295)."""
    return 15.0 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[0])


@dataclass
class GradientConstraintProblem:
    space: MixedSpace
    form: VolumeForm
    solver: LVPPSolver
    U: FunctionSpace
    Q: FunctionSpace
    x0: torch.Tensor

    def solve(self) -> LVPPResult:
        return self.solver.solve(self.x0)

    def u(self, result: LVPPResult) -> np.ndarray:
        return result.x[self.space.slice_of("u")].cpu().numpy()

    def psi(self, result: LVPPResult) -> np.ndarray:
        return result.x[self.space.slice_of("psi")].cpu().numpy()

    def active_set_dg0(self, result: LVPPResult, tol: float = 0.0
                       ) -> np.ndarray:
        """Per-cell indicator |grad u| >= phi (reference DG0 active_set,
        :134-138), evaluated at cell-midpoint quadrature."""
        form = self.form
        _, grads = form._eval_field("u", form._as(result.x), form.cell_data)
        gu = grads[:, :, 0, :].cpu().numpy()          # (e, q, gdim)
        xq = form.xq.cpu().numpy()
        phi_q = default_phi(xq.reshape(-1, 2).T).reshape(xq.shape[0], -1) \
            if self._phi_func is None else \
            self._phi_func(xq.reshape(-1, 2).T).reshape(xq.shape[0], -1)
        gnorm = np.linalg.norm(gu, axis=-1)
        return (gnorm.mean(axis=1) >= phi_q.mean(axis=1) - tol).astype(float)

    _phi_func: Optional[Callable] = None


def setup_gradient_constraint(
    N: int = 200,
    M: int = 200,
    primal_degree: int = 2,
    cell_type: str = "triangle",
    alpha_scheme: str = "doubling",
    alpha_0: float = 1.0,
    alpha_c: float = 1.0,
    max_iterations: int = 25,
    stopping_tol: float = 1e-8,
    phi_func: Callable = default_phi,
    f_func: Callable = default_f,
    warm_start: bool = False,
    quadrature_degree: int = 10,
    solver_options: Optional[Mapping] = None,
    mesh: Optional[Mesh] = None,
    verbose: bool = True,
    *,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> GradientConstraintProblem:
    device = torch.device(device)
    f64 = torch.float64
    mesh = mesh if mesh is not None else unit_square_mesh(
        N, M, cell_type=cell_type)
    gdim = mesh.gdim
    U = FunctionSpace.create(mesh, primal_degree)
    # vector latent of degree p-1; degree 0 -> DG0 vector
    Q = FunctionSpace.create(mesh, primal_degree - 1, value_size=gdim,
                             discontinuous=(primal_degree - 1 == 0))
    space = MixedSpace([("u", U), ("psi", Q)])

    def residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        psi = u["psi"]
        denom = torch.sqrt(1.0 + (psi * psi).sum(-1))
        a1_u = alpha * gu["u"] + psi - c["psi0"]
        a0_u = -alpha * c["f"]
        a0_psi = gu["u"] - c["phi"] * psi / denom
        return {"u": (a0_u, a1_u), "psi": (a0_psi, None)}

    def on_device(a):
        return torch.as_tensor(a, dtype=f64, device=device)

    form = VolumeForm(space, residual, quadrature_degree,
                      coeff_spaces={"psi0": Q, "u0": U}, device=device)
    phi_q = on_device(form.interpolate_to_quadrature(phi_func))
    f_q = on_device(form.interpolate_to_quadrature(f_func))

    bcs = [DirichletBC.from_marker("u", U, value=0.0)]
    problem = NonlinearProblem(
        form, bcs, coeffs={"phi": phi_q, "f": f_q},
        consts={"alpha": torch.tensor(alpha_0, dtype=f64, device=device)})

    u_sl, psi_sl = space.slice_of("u"), space.slice_of("psi")

    def prev_coeffs(x_k):
        return {"psi0": x_k[psi_sl], "u0": x_k[u_sl]}

    l2_fn = form.make_functional(
        lambda x, u, gu, c, gc, k: (u["u"] - c["u0"]) ** 2)

    def increment(x, x_k):
        coeffs = {"phi": phi_q, "f": f_q, **prev_coeffs(x_k)}
        return float(np.sqrt(max(float(l2_fn(x, coeffs, {})), 0.0)))

    opts = {"snes_atol": 1e-9, "snes_rtol": 1e-9, "snes_stol": 1e-9,
            "snes_max_it": 20, "snes_linesearch_type": "none",
            "ksp_type": "preonly", "pc_type": "lu"}
    opts.update(solver_options or {})

    solver = LVPPSolver(
        problem,
        newton_options=SolverOptions(opts),
        alpha=AlphaScheduler(scheme=alpha_scheme, C=alpha_0, c=alpha_c,
                             alpha_max=np.inf),
        prev_coeffs=prev_coeffs,
        increment=increment,
        tol=stopping_tol,
        max_iterations=max_iterations,
        verbose=verbose,
        timer=timer,
    )

    x0 = torch.zeros(space.num_dofs, dtype=f64, device=device)
    if warm_start:
        # Poisson warm start (reference :72-96): -Δu0 = f, u0 = 0 on bdry
        uspace = MixedSpace([("u", U)])
        pform = VolumeForm(
            uspace,
            lambda x, u, gu, c, gc, k: {"u": (-c["f"], gu["u"])},
            quadrature_degree, device=device)
        pf_q = on_device(pform.interpolate_to_quadrature(f_func))
        pprob = NonlinearProblem(pform, [DirichletBC.from_marker("u", U, 0.0)],
                                 coeffs={"f": pf_q})
        res = NewtonSolver(pprob, SolverOptions(
            {"snes_rtol": 1e-12, "ksp_type": "preonly", "pc_type": "lu"}),
            timer=timer).solve(uspace.zeros())
        x0[u_sl] = res.x

    prob = GradientConstraintProblem(space=space, form=form, solver=solver,
                                     U=U, Q=Q, x0=x0)
    prob._phi_func = phi_func
    return prob


def solve_gradient_constraint(**kwargs):
    prob = setup_gradient_constraint(**kwargs)
    return prob, prob.solve()
