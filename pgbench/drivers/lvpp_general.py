"""Driver of the general LVPP stack: the port's `ObstacleProblem` from
`models/obstacle.setup_obstacle_problem` (LVPPSolver -> NewtonSolver ->
NonlinearProblem -> VolumeForm, the workload's linear direction), built
once; each solve starts from zeros.

Between solves the Newton solver is brought back to the state a fresh
solve starts from: the lagged block-tridiagonal factor it keeps across
calls (`NewtonSolver._lagged_bt`) is dropped, so every solve factors
afresh as the first did. Its `refactors` counter runs on; a solve's
refactors are the difference across it. The problem's cached ELL
pattern and line blocking are kept: they depend on the mesh alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pgbench.harness import Answer


@dataclass
class State:
    prob: object
    cells: np.ndarray
    n_vertices: int


def setup(config: dict, workload: dict, inputs, device, dtype=None) -> State:
    import torch
    from proximalgalerkin_torch.mesh.mesh import Mesh
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    lv = config["lvpp"]
    mesh = Mesh("triangle", inputs.points, inputs.cells)
    prob = setup_obstacle_problem(
        mesh, polynomial_order=1, alpha_scheme=lv["alpha_scheme"],
        alpha_max=lv["alpha_max"],
        maximum_number_of_outer_loop_iterations=lv["max_outer"],
        tol_exit=lv["tol_exit"], obstacle=inputs.obstacle, f=0.0,
        quadrature_degree=lv["quadrature_degree"],
        solver_options={**config["newton"], **workload["params"]["solver"]},
        verbose=False,
        device=device, dtype=dtype or torch.float64)
    return State(prob, inputs.cells, len(inputs.points))


def reset(state: State) -> None:
    state.prob.solver.newton.__dict__.pop("_lagged_bt", None)


def warmup(state: State) -> None:
    """The first LVPP step of one solve: every shape of the direction
    (assembly, blocking, factor, refinement, observables) once."""
    solver = state.prob.solver
    keep = solver.max_iterations
    solver.max_iterations = 1
    try:
        reset(state)
        state.prob.solve()
    finally:
        solver.max_iterations = keep
    sync(state)


def sync(state: State) -> None:
    import torch
    dev = state.prob.problem.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phases(state: State) -> dict:
    """The Newton solver's PhaseTimer totals so far (seconds)."""
    return dict(state.prob.solver.newton.timer.totals)


def solve(state: State) -> Answer:
    reset(state)
    newton = state.prob.solver.newton
    before = newton.refactors
    r = state.prob.solve()
    x = r.x.cpu().numpy()               # the device-to-host copy
    space = state.prob.space
    fields = {}
    for name in ("u", "psi"):
        dofs = x[space.slice_of(name)]
        dm = np.asarray(space.spaces[name].dofmap, dtype=np.int64)
        out = np.empty(state.n_vertices, dtype=np.float64)
        out[state.cells] = dofs.astype(np.float64)[dm]
        fields[name] = out
    return Answer(
        counts={"outer": r.iterations, "newton": list(r.newton_steps),
                "refactors": newton.refactors - before},
        converged=bool(r.converged), fields=fields,
        extra={"alphas": list(r.step_sizes)})
