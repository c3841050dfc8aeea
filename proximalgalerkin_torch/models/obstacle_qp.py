"""Example 01 — QP formulation of the obstacle problem + cross-solver
comparison driver, in PyTorch.

The port of the reference package's models/obstacle_qp.py, which rebuilds
examples/01_obstacle_problem/obstacle_ipopt_galahad.py (QP setup :44-91,
ObstacleProblem class :94-127) and compare_all.py (five solvers on one
mesh, iteration-count table :19-182), against the port's own assembled
matrices and its TRB / interior-point / SNES-VI / LVPP solvers instead of
GALAHAD / IPOPT / PETSc. The stiffness and mass matrices are assembled on
`device` (element matrices there, the CSR on the host); TRB and the
interior point run on the host in numpy/scipy; the LVPP runs and the
SNES-VI residuals on `device`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..assembly import VolumeForm
from ..core.logging import PhaseTimer, rank_print
from ..mesh.mesh import Mesh
from ..solve.optimization import interior_point_solver, trb_solver
from ..spaces import FunctionSpace, MixedSpace
from .obstacle import spherical_cap_obstacle


def assemble_qp_operators(mesh: Mesh, degree: int = 1, *, device="cuda"):
    """Stiffness S, (consistent) mass M, and dof data for the QP form
    (reference setup_problem, obstacle_ipopt_galahad.py:44-91)."""
    V = FunctionSpace.create(mesh, degree)
    space = MixedSpace([("u", V)])
    stiff = VolumeForm(space, lambda x, u, gu, c, gc, k: {"u": (None, gu["u"])},
                       quadrature_degree=2 * degree, device=device)
    mass = VolumeForm(space, lambda x, u, gu, c, gc, k: {"u": (u["u"], None)},
                      quadrature_degree=2 * degree, device=device)
    S = stiff.assemble_scipy(space.zeros())
    M = mass.assemble_scipy(space.zeros())
    return V, S.tocsr(), M.tocsr()


class ObstacleQP:
    """min 0.5 x'Sx - (Mf)'x  s.t.  x >= phi, x = 0 on the boundary
    (enforced through equal bounds, the reference's 'Dirichlet bounds'
    device, optimization.py:81)."""

    def __init__(self, S: sp.csr_matrix, M: sp.csr_matrix,
                 f: np.ndarray):
        self.S = S
        self.b = M @ f
        Lo = sp.tril(S).tocoo()
        self._rows, self._cols = Lo.row.astype(np.int32), Lo.col.astype(np.int32)
        self._lower = Lo
        self.total_iteration_count = 0

    def objective(self, x):
        self.total_iteration_count += 1
        return 0.5 * x @ (self.S @ x) - self.b @ x

    def gradient(self, x):
        return self.S @ x - self.b

    def pure_hessian(self, x):
        return self._lower.data

    def hessian(self, x, lagrange, obj_factor):
        return obj_factor * self.pure_hessian(x)

    def hessianstructure(self):
        return self._rows, self._cols


@dataclass
class CompareResult:
    iterations: Dict[str, int]
    solutions: Dict[str, np.ndarray]

    def table(self) -> str:
        lines = ["Solver               Iterations",
                 "------               ----------"]
        for k, v in self.iterations.items():
            lines.append(f"{k:<20} {v}")
        return "\n".join(lines)


def compare_all(mesh: Mesh,
                obstacle: Callable = spherical_cap_obstacle,
                f: float = 0.0,
                max_iter: int = 500,
                tol: float = 1e-4,
                verbose: bool = True,
                *,
                device="cuda",
                timer: Optional[PhaseTimer] = None) -> CompareResult:
    """Run TRB (galahad stand-in), LVPP P1 and P2, interior point with and
    without exact Hessian, and semismooth VI Newton on the same mesh —
    the compare_all.py benchmark harness (:19-182). timer: a PhaseTimer
    that times the QP operators' assembly ('qp_operators') and each
    solver under its name in the table."""
    from ..solve.nonlinear import NonlinearProblem
    from ..solve.vi import vi_solve
    from ..spaces import DirichletBC
    from .obstacle import setup_obstacle_problem

    device = torch.device(device)
    timer = timer or PhaseTimer(device)
    its: Dict[str, int] = {}
    sols: Dict[str, np.ndarray] = {}

    with timer.phase("qp_operators"):
        V, S, M = assemble_qp_operators(mesh, 1, device=device)
    n = V.num_dofs
    phi = obstacle(V.dof_points.T)
    bdofs = np.asarray(V.boundary_dofs())
    lb = phi.copy()
    ub = np.full(n, np.inf)
    lb[bdofs] = 0.0
    ub[bdofs] = 0.0
    fvec = np.full(n, f)
    x0 = np.maximum(lb, 0.0)

    qp = ObstacleQP(S, M, fvec)
    with timer.phase("Galahad (TRB)"):
        x_trb, it_trb = trb_solver(qp, x0.copy(), (lb, ub),
                                   max_iter=max_iter, tol=tol)
    its["Galahad (TRB)"] = it_trb
    sols["Galahad (TRB)"] = x_trb

    for order in (1, 2):
        name = f"LVPP (P{order})"
        with timer.phase(name):
            prob = setup_obstacle_problem(
                mesh, polynomial_order=order,
                alpha_scheme="double_exponential", alpha_max=1e2,
                tol_exit=tol, verbose=False,
                maximum_number_of_outer_loop_iterations=max_iter,
                device=device)
            res = prob.solve()
            its[name] = res.total_newton
            sols[name] = prob.u(res)

    for name, hess in (("IPOPT (w. Hessian)", True),
                       ("IPOPT (no Hessian)", False)):
        qp_ip = ObstacleQP(S, M, fvec)
        with timer.phase(name):
            x_ip, it_ip = interior_point_solver(
                qp_ip, x0.copy(), (lb, ub), max_iter=max_iter, tol=tol,
                activate_hessian=hess)
        its[name] = it_ip
        sols[name] = x_ip

    # SNES-VI: F(u) = S u - M f with bounds phi <= u
    with timer.phase("SNES-VI"):
        space = MixedSpace([("u", V)])
        form = VolumeForm(space, lambda x, u, gu, c, gc, k:
                          {"u": (-f, gu["u"])}, quadrature_degree=2,
                          device=device)
        bc = DirichletBC.from_marker("u", V, value=0.0)
        nlp = NonlinearProblem(form, [bc])
        x_vi, reason, it_vi = vi_solve(
            nlp, np.zeros(n), phi.copy(), None,
            {"snes_atol": 1e-8, "snes_rtol": 1e-8, "snes_max_it": 1000})
    its["SNES-VI"] = it_vi
    sols["SNES-VI"] = x_vi.cpu().numpy()

    result = CompareResult(iterations=its, solutions=sols)
    if verbose:
        rank_print(result.table())
    return result
