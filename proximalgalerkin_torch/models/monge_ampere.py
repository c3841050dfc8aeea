"""Example 10 — Monge–Ampère with convexity constraint, in PyTorch.

The port of the reference package's models/monge_ampere.py
(examples/10_monge_ampere/monge_ampere_dolfinx.py): fully nonlinear
det D^2 u = rho with an SPD Hessian (convexity) enforced by the
matrix-exponential latent map Hessian = expm(psi) (:74-87). Mixed
(u: P_k, p: P_{k+1} vector, Psi: P_k 3-vector packing the symmetric 2x2
latent). One Newton solve per degree (the pure LVPP alpha -> inf limit),
l2 line search (:17), p-refinement sweep k = 3..kmax (:31) with a
point-evaluation warm start from the previous degree (:100-110), latent
initial guess psi = logm(Hessian(u_guess)) (:121-136), and a
manufactured-solution L2 error study against u = exp(|x|^2/2)
(:161-164).

Residual (:81-87), test functions (v, q, Phi):
  v-row:   (tr psi - ln rho) v
  q-row:   (p - grad u) . q
  Phi-row: grad p : phi - expm(psi) : phi   (phi the sym unpacking of Phi)

The warm start moves the previous degree's solution to the host for the
point evaluation (utils/pointeval.py), as the reference does; everything
else stays on the solve device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer, rank_print
from ..forms.maps import expm2
from ..mesh.generation import rectangle_mesh
from ..solve import NonlinearProblem
from ..solve.newton import NewtonSolver
from ..spaces import DirichletBC, FunctionSpace, MixedSpace
from ..utils.pointeval import evaluate


def u_exact_np(x):
    """Manufactured solution u = exp(|x|^2/2) (:42)."""
    return np.exp((x[0] ** 2 + x[1] ** 2) / 2.0)


def ln_rho(x):
    """ln det D^2 u_exact = |x|^2 + ln(1 + |x|^2) in closed form."""
    r2 = x[0] ** 2 + x[1] ** 2
    return r2 + torch.log(1.0 + r2)


@dataclass
class MongeAmpereResult:
    degrees: List[int]
    errors: List[float]
    newton_its: List[int]
    dofs: List[int]


def solve_monge_ampere_degree(degree: int, mesh=None,
                              warm_start: Optional[tuple] = None,
                              solver_options: Optional[dict] = None,
                              verbose: bool = True, *, device="cuda",
                              timer: Optional[PhaseTimer] = None):
    """One Newton solve at polynomial degree k = `degree`. Returns
    (space, x, newton_its, L2_error, mesh); x is a device tensor.
    warm_start: (space, x) of a previous solve, evaluated at this
    space's dof points."""
    device = torch.device(device)
    mesh = mesh if mesh is not None else rectangle_mesh(
        2, 2, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    k = degree
    V = FunctionSpace.create(mesh, k)                    # u
    U = FunctionSpace.create(mesh, k + 1, value_size=2)  # p
    W = FunctionSpace.create(mesh, k, value_size=3)      # packed sym latent
    space = MixedSpace([("u", V), ("p", U), ("Psi", W)])

    def residual(x, u, gu, c, gc, consts):
        Psi = u["Psi"]
        E = expm2(torch.stack([torch.stack([Psi[0], Psi[1]]),
                               torch.stack([Psi[1], Psi[2]])]))
        gp = gu["p"]                     # (2, 2): gp[m, d] = d p_m / d x_d
        a0_u = Psi[0] + Psi[2] - ln_rho(x)
        a0_p = u["p"] - gu["u"]
        a0_Psi = torch.stack([gp[0, 0] - E[0, 0],
                              gp[0, 1] + gp[1, 0] - 2.0 * E[0, 1],
                              gp[1, 1] - E[1, 1]])
        return {"u": (a0_u, None), "p": (a0_p, None), "Psi": (a0_Psi, None)}

    form = VolumeForm(space, residual, quadrature_degree=2 * (k + 2),
                      device=device)

    bc = DirichletBC.from_marker("u", V, value=u_exact_np)
    problem = NonlinearProblem(form, [bc])

    x0 = space.zeros()
    u_sl, p_sl, Psi_sl = (space.slice_of(n) for n in ("u", "p", "Psi"))
    if warm_start is not None:
        prev_space, prev_x = warm_start
        prev_host = prev_x.cpu().numpy()
        for name, sl in (("u", u_sl), ("p", p_sl), ("Psi", Psi_sl)):
            src = prev_space.spaces[name]
            dst = space.spaces[name]
            vals = evaluate(src, prev_host[prev_space.slice_of(name)],
                            dst.dof_points)
            x0[sl] = np.asarray(vals).reshape(-1)
    else:
        # u_guess = |x|^2, p = grad u_guess, Psi = logm(D^2 u_guess)
        # = logm(2 I) = ln(2) I (:111-136)
        pts = V.dof_points
        x0[u_sl] = pts[:, 0] ** 2 + pts[:, 1] ** 2
        ptsU = U.dof_points
        x0[p_sl] = (2.0 * ptsU).reshape(-1)
        nW = W.num_scalar_dofs
        psi0 = np.zeros((nW, 3))
        psi0[:, 0] = np.log(2.0)
        psi0[:, 2] = np.log(2.0)
        x0[Psi_sl] = psi0.reshape(-1)

    opts = {"snes_linesearch_type": "l2", "snes_rtol": 1e-8,
            "snes_atol": 1e-10, "snes_max_it": 100,
            "ksp_type": "preonly", "pc_type": "lu"}
    opts.update(solver_options or {})
    res = NewtonSolver(problem, SolverOptions(opts), timer=timer).solve(
        torch.as_tensor(x0, dtype=torch.float64, device=device))
    if not res.converged:
        raise RuntimeError(f"Monge-Ampère Newton failed at k={k}: "
                           f"{res.reason.name}")

    err_fn = form.make_functional(
        lambda x, u, gu, c, gc, kk:
        (u["u"] - torch.exp((x[0] ** 2 + x[1] ** 2) / 2.0)) ** 2)
    L2_err = float(np.sqrt(max(float(err_fn(res.x)), 0.0)))
    if verbose:
        rank_print(f"k={k}: dofs={space.num_dofs} newton={res.iterations} "
                   f"L2 error={L2_err:.3e}")
    return space, res.x, res.iterations, L2_err, mesh


def p_refinement_sweep(kmin: int = 3, kmax: int = 14,
                       verbose: bool = True, *, device="cuda",
                       timer: Optional[PhaseTimer] = None
                       ) -> MongeAmpereResult:
    """The reference's degree sweep with warm starts (:31,100-110)."""
    mesh = rectangle_mesh(2, 2, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    result = MongeAmpereResult([], [], [], [])
    warm = None
    for k in range(kmin, kmax + 1):
        space, x, its, err, mesh = solve_monge_ampere_degree(
            k, mesh=mesh, warm_start=warm, verbose=verbose, device=device,
            timer=timer)
        warm = (space, x)
        result.degrees.append(k)
        result.errors.append(err)
        result.newton_its.append(its)
        result.dofs.append(space.num_dofs)
    return result


def h_refinement_sweep(levels: int = 3, degree: int = 4,
                       verbose: bool = True, *, device="cuda",
                       timer: Optional[PhaseTimer] = None
                       ) -> MongeAmpereResult:
    """The Firedrake twin's protocol (monge_ampere_firedrake.py:9-114):
    fixed degree, uniform refinements with prolonged warm starts,
    reporting L2 errors and convergence orders."""
    from ..mesh.unstructured import refine_uniform
    mesh = rectangle_mesh(2, 2, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    result = MongeAmpereResult([], [], [], [])
    warm = None
    for lvl in range(levels):
        space, x, its, err, _ = solve_monge_ampere_degree(
            degree, mesh=mesh, warm_start=warm, verbose=verbose,
            device=device, timer=timer)
        warm = (space, x)
        result.degrees.append(lvl)
        result.errors.append(err)
        result.newton_its.append(its)
        result.dofs.append(space.num_dofs)
        if lvl < levels - 1:
            mesh = refine_uniform(mesh)
    if verbose:
        e = np.array(result.errors)
        orders = np.log2(e[:-1] / e[1:])
        rank_print(f"Convergence orders: {orders}")
    return result
