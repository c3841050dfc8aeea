"""Driver of the distributed LVPP path (parallel/dofpart.py): the port's
obstacle problem from `models/obstacle.setup_obstacle_problem`, cut into
`subdomains` subdomains on the leading shard axis of one device
(`DistributedProblem`), its LVPP solve driven by `LVPPSolver` over
`DistributedLvppProblem` as `cli._run_obstacle_distributed` builds it,
with the workload's Newton options. Built once; each solve starts from
the scattered zero vector.

Nothing is carried across solves but what depends on the mesh alone
(the subdomain blocking of asm_btlu, cached by the problem): each Newton
step captures its own Jacobian action and Schwarz apply. A solve has
converged when each of its `max_outer` outer steps did (the LVPP stops
at the first Newton solve that does not; its tolerance is never met).
Counts are the outer steps and the Newton steps of each; GMRES
iterations and the subdomain layout go in `extra`, since on a card the
assembly's f64 `index_add` sums in atomic order and an iteration more
or less is no fault.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pgbench.harness import Answer


@dataclass
class State:
    prob: object                   # the port's ObstacleProblem
    dp: object                     # DistributedProblem
    solver: object                 # LVPPSolver over DistributedLvppProblem
    max_outer: int
    cells: np.ndarray
    n_vertices: int


def setup(config: dict, workload: dict, inputs, device, dtype=None) -> State:
    import torch
    from proximalgalerkin_torch.mesh.mesh import Mesh
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    from proximalgalerkin_torch.parallel.dofpart import (
        DistributedLvppProblem, DistributedProblem)
    from proximalgalerkin_torch.solve.lvpp import AlphaScheduler, LVPPSolver
    lv = config["lvpp"]
    mesh = Mesh("triangle", inputs.points, inputs.cells)
    prob = setup_obstacle_problem(
        mesh, polynomial_order=1, alpha_scheme=lv["alpha_scheme"],
        alpha_max=lv["alpha_max"],
        maximum_number_of_outer_loop_iterations=lv["max_outer"],
        tol_exit=lv["tol_exit"], obstacle=inputs.obstacle, f=0.0,
        quadrature_degree=lv["quadrature_degree"], verbose=False,
        device=device, dtype=dtype or torch.float64)
    p_ = prob.problem
    dp = DistributedProblem(p_, n_devices=int(config["subdomains"]))
    dlp = DistributedLvppProblem(dp)
    dlp.update(coeffs={"phi": dp.scatter_cellq(p_.coeffs["phi"])})
    solver = LVPPSolver(
        dlp,
        newton_options={**config["newton"], **workload["params"]["solver"]},
        alpha=AlphaScheduler(scheme=lv["alpha_scheme"],
                             alpha_max=lv["alpha_max"]),
        prev_coeffs=lambda xs: {"psi_k": dp.field_to_coeff(xs, "psi"),
                                "u_k": dp.field_to_coeff(xs, "u")},
        tol=lv["tol_exit"], max_iterations=lv["max_outer"], verbose=False)
    return State(prob, dp, solver, int(lv["max_outer"]), inputs.cells,
                 len(inputs.points))


def _x0(state: State):
    return state.dp.scatter(np.zeros(state.prob.space.num_dofs))


def warmup(state: State) -> None:
    """One Newton step of the first LVPP step: every shape (the action's
    graph, the subdomain factor, the apply's graph, a GMRES cycle)."""
    opts = state.solver.newton.options
    keep = opts.opt("snes_max_it")
    opts["snes_max_it"] = 1
    try:
        state.solver.solve(_x0(state))
    finally:
        opts["snes_max_it"] = keep
    sync(state)


def sync(state: State) -> None:
    import torch
    if state.dp.device.type == "cuda":
        torch.cuda.synchronize(state.dp.device)


def phases(state: State) -> dict:
    """The Newton solver's PhaseTimer totals so far (seconds)."""
    return dict(state.solver.newton.timer.totals)


def layout(state: State) -> dict:
    """The subdomain layout: owned and extended dofs a subdomain and the
    subdomain factor's blocking (nb, bs)."""
    abt = state.dp._asm_btlu_setup()
    return {"owned": int(state.dp.Bsum), "ext_total": int(state.dp.ext_total),
            "nb_bs": [int(abt["nb"]), int(abt["bs"])]}


def solve(state: State) -> Answer:
    newton = state.solver.newton
    k0 = len(newton.krylov_its)
    r = state.solver.solve(_x0(state))
    x = state.dp.gather(r.x)            # the device-to-host copy
    space = state.prob.space
    fields = {}
    for name in ("u", "psi"):
        dofs = x[space.slice_of(name)]
        dm = np.asarray(space.spaces[name].dofmap, dtype=np.int64)
        out = np.empty(state.n_vertices, dtype=np.float64)
        out[state.cells] = dofs.astype(np.float64)[dm]
        fields[name] = out
    return Answer(
        counts={"outer": r.iterations, "newton": list(r.newton_steps)},
        converged=r.iterations == state.max_outer, fields=fields,
        extra={"gmres_its": [int(i) for i in newton.krylov_its[k0:]],
               "alphas": list(r.step_sizes), **layout(state)})
