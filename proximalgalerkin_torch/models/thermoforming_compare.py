"""Example 05 comparison solvers — Moreau–Yosida penalty, fixed-point, and
semismooth active-set baselines for the thermoforming QVI, in PyTorch.

The port of the reference package's models/thermoforming_compare.py (the
Julia/Gridap suite examples/05_obstacle_type_qvi/solver_comparison/): the
Moreau–Yosida path-following solver (thermoforming_moreau_yosida.jl:75-160:
penalty gamma*max(u - (Phi0 + xi T), 0), gamma-update rule, H1
Cauchy-norm termination), the alternating fixed-point solver with
penalized inner obstacle solves (thermoforming_fixed_point.jl:128-146),
and a semismooth (active-set) Newton on the complementarity system — each
reporting (iterations, total linear solves) like the Julia scripts print.

max(s, 0) is torch.maximum against a zero tensor, whose derivative at a
tie is 1/2 as the reference's (the semismooth baseline's generalized
derivative is exactly this rule); never torch.relu or torch.clamp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer, rank_print
from ..mesh.generation import unit_square_mesh
from ..solve import NonlinearProblem
from ..solve.newton import NewtonSolver
from ..spaces import DirichletBC, FunctionSpace, MixedSpace
from .thermoforming import mollifier, mould0, xi


def _pos(s):
    """max(s, 0) with the reference's derivative 1/2 at s = 0."""
    return torch.maximum(s, torch.zeros_like(s))


@dataclass
class QVIBaselineResult:
    u: np.ndarray
    T: np.ndarray
    outer_iterations: int
    linear_solves: int
    converged: bool


def _setup(M, q_bound, f, beta=1.0):
    mesh = unit_square_mesh(M, M)
    V = FunctionSpace.create(mesh, 1)
    space = MixedSpace([("u", V), ("T", V)])

    def g(s):
        return mollifier(s, q_bound)

    return mesh, V, space, g, mould0, xi


def moreau_yosida_solve(M: int = 150, q_bound: float = 0.01, f: float = 25.0,
                        tol: float = 1e-5, max_outer: int = 100,
                        verbose: bool = True, *, device="cuda",
                        timer: Optional[PhaseTimer] = None
                        ) -> QVIBaselineResult:
    """Penalty path-following (thermoforming_moreau_yosida.jl)."""
    device = torch.device(device)
    f64 = torch.float64
    mesh, V, space, g, mould0, xi = _setup(M, q_bound, f)

    def residual(x, u, gu, c, gc, consts):
        gam = consts["gamma"]
        mould = mould0(x) + xi(x) * u["T"]
        a0_u = -f + gam * _pos(u["u"] - mould)
        a1_u = gu["u"]
        a0_T = u["T"] - g(mould - u["u"])
        a1_T = gu["T"]
        return {"u": (a0_u, a1_u), "T": (a0_T, a1_T)}

    form = VolumeForm(space, residual, quadrature_degree=4, device=device)
    bcs = [DirichletBC.from_marker("u", V, value=0.0)]
    problem = NonlinearProblem(form, bcs, consts={"gamma": torch.tensor(
        1.0, dtype=f64, device=device)})
    # the Julia reference runs BackTracking(c_1=-1e8): the sufficient-
    # decrease test is vacuous, i.e. full Newton steps (:136)
    # NLsolve ftol=1e-5 is an ABSOLUTE residual test (:136)
    newton = NewtonSolver(problem, SolverOptions(
        {"snes_linesearch_type": "none", "snes_rtol": 1e-12, "snes_atol": 1e-5,
         "snes_max_it": 60, "ksp_type": "preonly", "pc_type": "lu"}),
        timer=timer)

    energy_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        0.5 * (gu["u"] * gu["u"]).sum(-1) - f * u["u"])
    infeas_fn = form.make_functional(
        lambda x, u, gu, c, gc, k:
        0.5 * k["gamma"] * _pos(
            u["u"] - (mould0(x) + xi(x) * u["T"])) ** 2)

    # u_prev enters the H1 functional as a FE coefficient
    form2 = VolumeForm(space, residual, quadrature_degree=4,
                       coeff_spaces={"u_prev": V}, device=device)
    h1_fn = form2.make_functional(
        lambda x, u, gu, c, gc, k:
        (u["u"] - c["u_prev"]) ** 2
        + ((gu["u"] - gc["u_prev"]) ** 2).sum(-1))

    u_sl, T_sl = space.slice_of("u"), space.slice_of("T")
    x = torch.zeros(space.num_dofs, dtype=f64, device=device)
    x[T_sl] = 1.0
    gamma = 1.0
    linear_solves = 0
    converged = False
    j = 0
    for j in range(1, max_outer + 1):
        gam_t = torch.tensor(gamma, dtype=f64, device=device)
        problem.update(consts={"gamma": gam_t})
        u_prev = x[u_sl]
        res = newton.solve(x)
        ok = (bool(torch.all(torch.isfinite(res.x)))
              and res.fnorm <= res.fnorm_history[0])
        # accept only residual-reducing iterates: full-step Newton can
        # cycle on the max() kink at large gamma; the penalty path keeps
        # tightening either way
        if ok:
            x = res.x
        linear_solves += res.iterations
        cauchy = float(np.sqrt(max(float(
            h1_fn(x, {"u_prev": u_prev}, {})), 0.0)))
        # gamma update rule (:75-110)
        infeas = float(infeas_fn(x, {}, {"gamma": gam_t}))
        func = float(energy_fn(x))
        if verbose:
            rank_print(f"MY j={j} gamma={gamma:.3e} newton={res.iterations} "
                       f"cauchy={cauchy:.3e} infeas={infeas:.3e}")
        if cauchy < tol:
            converged = True
            break
        if abs(func) > 1e-14:
            E = gamma * infeas / func
            theta = func + infeas
            if abs(E) > 1e-300:
                C2 = E * (E + gamma) * theta / gamma
                C1 = C2 / E
                tau = 1.0 / (j + 1)
                g_new = C2 / (tau * abs(C1 - theta)) - E
                if np.isfinite(g_new) and g_new > 0:
                    # growth cap keeps full-step Newton in its basin
                    gamma = min(g_new, gamma * 100.0)
    return QVIBaselineResult(u=x[u_sl].cpu().numpy(),
                             T=x[T_sl].cpu().numpy(),
                             outer_iterations=j, linear_solves=linear_solves,
                             converged=converged)


def fixed_point_solve(M: int = 150, q_bound: float = 0.01, f: float = 25.0,
                      tol: float = 1e-5, max_outer: int = 100,
                      gamma: float = 1e6,
                      verbose: bool = True, *, device="cuda",
                      timer: Optional[PhaseTimer] = None
                      ) -> QVIBaselineResult:
    """Alternating T-solve / penalized-u-solve (thermoforming_fixed_point.jl
    :128-146)."""
    device = torch.device(device)
    f64 = torch.float64
    mesh, V, space_uT, g, mould0, xi = _setup(M, q_bound, f)
    space_u = MixedSpace([("u", V)])
    space_T = MixedSpace([("T", V)])

    def u_residual(x, u, gu, c, gc, consts):
        a0 = -f + consts["gamma"] * _pos(u["u"] - c["mould"])
        return {"u": (a0, gu["u"])}

    def T_residual(x, u, gu, c, gc, consts):
        return {"T": (u["T"] - g(c["mould_u"]), gu["T"])}

    form_u = VolumeForm(space_u, u_residual, 4, device=device)
    form_T = VolumeForm(space_T, T_residual, 4, device=device)
    prob_u = NonlinearProblem(form_u, [DirichletBC.from_marker("u", V, 0.0)],
                              consts={"gamma": torch.tensor(
                                  gamma, dtype=f64, device=device)})
    prob_T = NonlinearProblem(form_T, [])
    nt_u = NewtonSolver(prob_u, SolverOptions(
        {"snes_linesearch_type": "bt", "snes_rtol": 1e-6, "snes_atol": 1e-9,
         "ksp_type": "preonly", "pc_type": "lu", "snes_max_it": 60}),
        timer=timer)
    nt_T = NewtonSolver(prob_T, SolverOptions(
        {"snes_rtol": 1e-10, "ksp_type": "preonly", "pc_type": "lu"}),
        timer=timer)

    xq_u = form_u.xq
    mould0_q = 1 - 2 * torch.maximum(torch.abs(xq_u[..., 0] - 0.5),
                                     torch.abs(xq_u[..., 1] - 0.5))
    xi_q = (torch.sin(torch.pi * xq_u[..., 0])
            * torch.sin(torch.pi * xq_u[..., 1]))

    u = torch.zeros(V.num_dofs, dtype=f64, device=device)
    T = torch.ones(V.num_dofs, dtype=f64, device=device)
    linear = 0
    converged = False

    # evaluate T at u-quadrature points via the FE tables
    form_eval = VolumeForm(space_u, u_residual, 4, coeff_spaces={"Tc": V},
                           device=device)

    def T_at_q(Tvec):
        v, _ = form_eval._eval_coeff("Tc", Tvec, form_eval.cell_data)
        return v[:, :, 0]

    def u_at_q(uvec):
        v, _ = form_eval._eval_field("u", uvec, form_eval.cell_data)
        return v[:, :, 0]

    it = 0
    for it in range(1, max_outer + 1):
        u_prev = u
        # T-solve given u: the g-term uses the CURRENT mould gap; lag it
        # with the previous iterates
        gap_q = mould0_q + xi_q * T_at_q(T) - u_at_q(u)
        prob_T.update(coeffs={"mould_u": gap_q})
        resT = nt_T.solve(T)
        T = resT.x
        linear += resT.iterations
        # u-solve given T
        mould_q = mould0_q + xi_q * T_at_q(T)
        prob_u.update(coeffs={"mould": mould_q})
        resu = nt_u.solve(u)
        u = resu.x
        linear += resu.iterations
        diff = float(torch.linalg.norm(u - u_prev))
        if verbose:
            rank_print(f"FP it={it} linear={linear} |du|={diff:.3e}")
        if diff < tol:
            converged = True
            break
    return QVIBaselineResult(u=u.cpu().numpy(), T=T.cpu().numpy(),
                             outer_iterations=it, linear_solves=linear,
                             converged=converged)


def semismooth_active_set_solve(M: int = 150, q_bound: float = 0.01,
                                f: float = 25.0, tol: float = 1e-10,
                                max_outer: int = 50,
                                verbose: bool = True, *, device="cuda",
                                timer: Optional[PhaseTimer] = None
                                ) -> QVIBaselineResult:
    """Semismooth Newton on the QVI complementarity system (the role of
    SemismoothQVIs.jl in thermoforming_semismooth_active_set.jl:55-60):
    equivalent to Moreau–Yosida with a fixed large penalty, for which the
    max() generalized derivative makes Newton semismooth."""
    total = 0
    x0 = None
    res = None
    for gamma in (1e2, 1e4, 1e8):
        res = moreau_yosida_like_fixed_gamma(M, q_bound, f, gamma, tol,
                                             max_outer, verbose, x0=x0,
                                             device=device, timer=timer)
        total += res.linear_solves
        x0 = (res.u, res.T)
    res.linear_solves = total
    res.outer_iterations = total
    return res


def moreau_yosida_like_fixed_gamma(M, q_bound, f, gamma, tol, max_outer,
                                   verbose, x0=None, *, device="cuda",
                                   timer: Optional[PhaseTimer] = None):
    device = torch.device(device)
    f64 = torch.float64
    mesh, V, space, g, mould0, xi = _setup(M, q_bound, f)

    def residual(x, u, gu, c, gc, consts):
        mould = mould0(x) + xi(x) * u["T"]
        a0_u = -f + consts["gamma"] * _pos(u["u"] - mould)
        a0_T = u["T"] - g(mould - u["u"])
        return {"u": (a0_u, gu["u"]), "T": (a0_T, gu["T"])}

    form = VolumeForm(space, residual, quadrature_degree=4, device=device)
    problem = NonlinearProblem(form, [DirichletBC.from_marker("u", V, 0.0)],
                               consts={"gamma": torch.tensor(
                                   gamma, dtype=f64, device=device)})
    newton = NewtonSolver(problem, SolverOptions(
        {"snes_linesearch_type": "bt", "snes_rtol": 1e-10,
         "snes_atol": 1e-8, "snes_max_it": max_outer,
         "ksp_type": "preonly", "pc_type": "lu"}), timer=timer)
    x = torch.zeros(space.num_dofs, dtype=f64, device=device)
    if x0 is None:
        x[space.slice_of("T")] = 1.0
    else:
        x[space.slice_of("u")] = torch.as_tensor(x0[0], dtype=f64,
                                                 device=device)
        x[space.slice_of("T")] = torch.as_tensor(x0[1], dtype=f64,
                                                 device=device)
    res = newton.solve(x)
    return QVIBaselineResult(
        u=res.x[space.slice_of("u")].cpu().numpy(),
        T=res.x[space.slice_of("T")].cpu().numpy(),
        outer_iterations=res.iterations, linear_solves=res.iterations,
        converged=res.converged)
