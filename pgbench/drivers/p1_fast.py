"""Driver of the fast path: the port's `P1ObstacleSolver` built once as
`cli.run_bench` builds it (alpha capped at 1e2, outer increment 1e-8,
mixed precision, the workload's inner preconditioner), warmed up once
with `cli.warmup_newton`, then `solve()` from its fixed initial state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pgbench.harness import Answer


@dataclass
class State:
    solver: object
    dofmap: np.ndarray         # (e, 3) dof of each cell vertex
    cells: np.ndarray
    n_vertices: int


def build_kernels(device) -> None:
    """Build the port's CUDA kernels (a cached nvcc build inside the
    checkout) before anything is timed."""
    if device.type == "cuda":
        from proximalgalerkin_torch.ops import dia_spmv, mgfused
        mgfused.build()
        dia_spmv.build()


def setup(config: dict, workload: dict, inputs, device, dtype=None) -> State:
    import torch
    from proximalgalerkin_torch.mesh.mesh import Mesh
    from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
    build_kernels(device)
    opts = dict(config["solver"], **workload["params"].get("solver", {}))
    mesh = Mesh("triangle", inputs.points, inputs.cells)
    solver = P1ObstacleSolver(
        mesh, obstacle=inputs.obstacle, f=0.0, alpha_cap=opts["alpha_cap"],
        outer_tol=opts["outer_tol"],
        mixed_precision=opts["mixed_precision"], pc=opts["pc"],
        device=device, dtype=dtype or torch.float64)
    return State(solver, np.asarray(solver.V.dofmap, dtype=np.int64),
                 inputs.cells, len(inputs.points))


def warmup(state: State) -> None:
    from proximalgalerkin_torch.cli import warmup_newton
    warmup_newton(state.solver)


def to_vertices(state: State, dof_values: np.ndarray) -> np.ndarray:
    out = np.empty(state.n_vertices, dtype=np.float64)
    out[state.cells] = np.asarray(dof_values, dtype=np.float64)[state.dofmap]
    return out


def solve(state: State) -> Answer:
    r = state.solver.solve()           # ends in a device-to-host copy
    return Answer(
        counts={"outer": r.outer_iterations,
                "newton": list(r.newton_per_outer)},
        converged=bool(r.converged),
        fields={"u": to_vertices(state, r.u),
                "psi": to_vertices(state, r.psi)},
        extra={"cg": int(r.cg_its_total), "newton_total": r.newton_its})
