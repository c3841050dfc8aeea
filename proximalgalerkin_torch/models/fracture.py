"""Example 03 — phase-field fracture with damage bounds, in PyTorch.

The port of the reference package's models/fracture.py
(examples/03_fracture/fracture_dolfinx.py), on one device:
antiplane-shear phase-field fracture on the cracked plate
(mesh/unstructured.py replaces netgen), 3-field P1 (u, c, psi),
irreversible damage bound c_prev <= c <= 1 via the interval latent map
(c_prev + exp(psi)) / (exp(psi) + 1) (:114), energy

  E = 1/2 G ((1-eps)(1-c)^2 + eps) |grad u|^2
    + 1/2 Gc/l c^2 + 1/2 Gc l |grad c|^2          (:118-124)

(torch.func.grad of the density inside the residual) with l = the maximum
cell diameter (:87-94), regularized Jacobian
J = F' + reps (v v' + d d' - phi phi') (:132-138), load continuation over
T in linspace(Tmin, Tmax, num_load_steps) driving u = +/-T on the two top
edges (:140-159,207-214), the adaptive-alpha failure-retry machine
(:220-284) and broken-specimen termination (:289-294).

With n_devices the whole continuation runs dof-partitioned over that many
subdomains (parallel/dofpart.py), as the reference's mpirun execution of
the same loop does.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
from torch.func import grad

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer, rank_print
from ..forms.maps import sigmoid_interval
from ..mesh.mesh import Mesh
from ..mesh.unstructured import TaggedMesh, create_crack_mesh
from ..solve import NonlinearProblem
from ..solve.newton import NewtonSolver
from ..spaces import DirichletBC, FunctionSpace, MixedSpace
from ..utils.checkpoint import LVPPCheckpoint


def _circumradius(mesh: Mesh) -> np.ndarray:
    """Per-cell circumradius (ufl.Circumradius equivalent) for triangles
    (the reference's models/multiphase.py:38-46)."""
    pts = mesh.points[mesh.cell_vertices]
    a = np.linalg.norm(pts[:, 1] - pts[:, 2], axis=1)
    b = np.linalg.norm(pts[:, 0] - pts[:, 2], axis=1)
    c = np.linalg.norm(pts[:, 0] - pts[:, 1], axis=1)
    s = 0.5 * (a + b + c)
    area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 1e-300))
    return a * b * c / (4.0 * area)


@dataclass
class FractureResult:
    u: np.ndarray
    c: np.ndarray
    load_history: List[float] = field(default_factory=list)
    newton_per_step: List[int] = field(default_factory=list)
    lvpp_per_step: List[int] = field(default_factory=list)
    broken: bool = False
    max_damage_history: List[float] = field(default_factory=list)
    retries_per_step: List[int] = field(default_factory=list)


def solve_fracture(
    tagged: Optional[TaggedMesh] = None,
    max_res: float = 0.05,
    G: float = 1.0,
    Gc: float = 1.0,
    eps: float = 1e-5,
    reps: float = 1e-3,
    Tmin: float = 0.0,
    Tmax: float = 5.0,
    num_load_steps: int = 1001,
    lvpp_tol: float = 1e-4,
    nfail_max: int = 50,
    solver_options: Optional[dict] = None,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    progress_jsonl: Optional[str] = None,
    n_devices: Optional[int] = None,
    *,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> FractureResult:
    """checkpoint_path: npz snapshot of (x, x_prev, alpha, step, histories)
    written every `checkpoint_every` load steps and loaded on entry if
    present (the reference's file format: a continuation checkpointed by
    either package resumes in the other). progress_jsonl: one JSON line
    appended per load step.

    n_devices: run the whole continuation dof-partitioned over that many
      subdomains (parallel/dofpart.py), all on `device` — load-step BC
      updates, the failure-retry machine, and the ||c_k - c_iter||
      functional on the shard axis, the reference's MPI-parallel
      execution of the same loop (fracture_dolfinx.py:220-264 under
      mpirun). Newton directions use the distributed MINRES with the
      configured pc_type (a direct pc maps to restricted additive
      Schwarz under GMRES). Checkpoints hold the global vectors, so a
      distributed run resumes a host run's checkpoint and the other way
      round.

    timer: a PhaseTimer for the Newton solver's phases."""
    device = torch.device(device)
    f64 = torch.float64
    tagged = tagged if tagged is not None else create_crack_mesh(max_res)
    mesh = tagged.mesh
    V = FunctionSpace.create(mesh, 1)
    space = MixedSpace([("u", V), ("c", V), ("psi", V)])

    # l = max cell diameter (4 * circumradius maximum, :87-94)
    l = float(4.0 * _circumradius(mesh).max())
    if verbose:
        rank_print(f"Using l = {l}")

    def energy_density(vals, grads):
        u_, c_ = vals["u"], vals["c"]
        gu_, gc_ = grads["u"], grads["c"]
        degr = (1.0 - eps) * (1.0 - c_) ** 2 + eps
        return (0.5 * G * degr * (gu_ * gu_).sum(-1)
                + 0.5 * Gc / l * c_ * c_
                + 0.5 * Gc * l * (gc_ * gc_).sum(-1))

    def residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        vals = {"u": u["u"], "c": u["c"]}
        grads = {"u": gu["u"], "c": gu["c"]}
        de_dv, de_dg = grad(lambda s: energy_density(s[0], s[1]))(
            (vals, grads))
        # overflow-safe form of (c_prev + e^psi)/(e^psi + 1) (:114): the
        # interval map c_prev + (1 - c_prev) * sigmoid(psi)
        c_conform = sigmoid_interval(u["psi"], lo=c["c_prev"], hi=1.0)
        a0_u = alpha * de_dv["u"]
        a1_u = alpha * de_dg["u"]
        a0_c = alpha * de_dv["c"] + (u["psi"] - c["psi_iter"])
        a1_c = alpha * de_dg["c"]
        a0_p = u["c"] - c_conform
        return {"u": (a0_u, a1_u), "c": (a0_c, a1_c), "psi": (a0_p, None)}

    def jac_residual(x, u, gu, c, gc, consts):
        # + reps (u, c, -psi) mass terms — derivative gives the
        # regularization reps(vv' + dd' - phi phi') (:132-138)
        out = residual(x, u, gu, c, gc, consts)
        a0u, a1u = out["u"]
        a0c, a1c = out["c"]
        a0p, a1p = out["psi"]
        out["u"] = (a0u + reps * u["u"], a1u)
        out["c"] = (a0c + reps * u["c"], a1c)
        out["psi"] = (a0p - reps * u["psi"], a1p)
        return out

    form = VolumeForm(space, residual, quadrature_degree=4,
                      jacobian_fn=jac_residual,
                      coeff_spaces={"c_prev": V, "psi_iter": V,
                                    "c_iter": V}, device=device)

    right_dofs = V.facet_closure_dofs(tagged.facets("topright"))
    left_dofs = V.facet_closure_dofs(tagged.facets("topleft"))

    def make_bcs(T):
        return [DirichletBC("u", right_dofs, np.full(len(right_dofs), T)),
                DirichletBC("u", left_dofs, np.full(len(left_dofs), -T))]

    problem = NonlinearProblem(form, make_bcs(0.0), consts={
        "alpha": torch.tensor(1.0, dtype=f64, device=device)})

    opts = {"snes_linesearch_type": "l2", "snes_atol": 1e-6,
            "snes_rtol": 1e-8, "snes_max_it": 50,
            "ksp_type": "preonly", "pc_type": "lu"}
    opts.update(solver_options or {})

    u_sl, c_sl, psi_sl = (space.slice_of(n) for n in ("u", "c", "psi"))
    l2c_integrand = lambda x, u, gu, c, gc, k: (u["c"] - c["c_iter"]) ** 2
    alpha_t = lambda a: torch.tensor(a, dtype=f64, device=device)

    if n_devices is None:
        newton = NewtonSolver(problem, SolverOptions(opts), timer=timer)
        l2c_fn = form.make_functional(l2c_integrand)

        def update_state(x_prev, x_iter, a):
            problem.update(
                coeffs={"c_prev": x_prev[c_sl], "psi_iter": x_iter[psi_sl],
                        "c_iter": x_iter[c_sl]},
                consts={"alpha": alpha_t(a)})

        def to_shard(a):
            return torch.as_tensor(np.asarray(a), dtype=f64, device=device)

        from_shard = lambda v: v.cpu().numpy()
        set_bcs = None
        l2c = lambda xx: l2c_fn(xx, dict(problem.coeffs), {})
        max_c = lambda xx: float(xx[c_sl].max())
        allclose = lambda a, b: bool(torch.allclose(a, b))
    else:
        from ..parallel.dofpart import (DistributedLvppProblem,
                                        DistributedProblem)
        dp = DistributedProblem(problem, n_devices=n_devices)
        dlp = DistributedLvppProblem(dp)
        newton = dlp.make_newton_solver(SolverOptions(opts), timer=timer)
        l2c_dist = dp.make_functional(l2c_integrand)
        to_shard = lambda v: dp.scatter(np.asarray(v))
        from_shard = dp.gather
        set_bcs = dp.update_bcs

        def update_state(x_prev, x_iter, a):
            dlp.update(
                coeffs={"c_prev": dp.field_to_coeff(x_prev, "c"),
                        "psi_iter": dp.field_to_coeff(x_iter, "psi"),
                        "c_iter": dp.field_to_coeff(x_iter, "c")},
                consts={"alpha": alpha_t(a)})

        l2c = lambda xx: l2c_dist(xx, dict(dlp.coeffs), dict(dlp.consts))
        max_c = lambda xx: float(dp.comm.pmax(
            dp.field_to_coeff(xx, "c").amax(-1)))
        allclose = lambda a, b: int(dp.comm.psum(
            (~torch.isclose(a, b)).sum(-1))) == 0

    x = to_shard(space.zeros())
    x_prev = x        # previous load step
    alpha = 1.0
    result = FractureResult(u=np.zeros(V.num_dofs), c=np.zeros(V.num_dofs))

    start_step = 0
    if checkpoint_path is not None and Path(checkpoint_path).exists():
        ck = LVPPCheckpoint.load(checkpoint_path)
        x = to_shard(ck.x)
        x_prev = to_shard(ck.x_k)
        alpha = float(ck.alpha_prev_raw)
        start_step = int(ck.step)
        result.newton_per_step = list(ck.newton_steps)
        result.load_history = list(ck.observables.get("load", []))
        result.lvpp_per_step = [
            int(v) for v in ck.observables.get("lvpp", [])]
        result.max_damage_history = list(
            ck.observables.get("max_damage", []))
        if verbose:
            rank_print(f"Resuming fracture continuation at load step "
                       f"{start_step} (alpha={alpha})")

    def _save_ck(step):
        LVPPCheckpoint(
            x=from_shard(x), x_k=from_shard(x_prev), iteration=0,
            alpha_prev_raw=alpha, step=step,
            newton_steps=result.newton_per_step,
            observables={"load": result.load_history,
                         "lvpp": [float(v) for v in result.lvpp_per_step],
                         "max_damage": result.max_damage_history},
        ).save(checkpoint_path)

    def _emit(step, T, newton_count, lvpp_count):
        if progress_jsonl is None:
            return
        with open(progress_jsonl, "a") as f:
            f.write(json.dumps(
                {"step": step, "T": float(T), "newton": int(newton_count),
                 "lvpp": int(lvpp_count), "alpha": alpha,
                 "max_damage": result.max_damage_history[-1]}) + "\n")

    loads = np.linspace(Tmin, Tmax, num_load_steps)[1:]
    for step, T in enumerate(loads):
        if step < start_step:
            continue
        if verbose:
            rank_print(f"Solving for T = {float(T):.4f} "
                       f"({step / max(len(loads), 1) * 100:.1f}%)")
        bc_idx, bc_vals = space.global_bc_arrays(make_bcs(float(T)))
        problem.set_bc_arrays(bc_idx, bc_vals)
        if set_bcs is not None:
            set_bcs(bc_idx, bc_vals)

        # the reference resets the proximal parameter at every load step
        # (fracture_dolfinx.py:215 `alpha.value = 1`)
        alpha = 1.0
        x_iter = x
        k, nfail = 1, 0
        newton_count = 0
        lvpp_count = 0
        while nfail <= nfail_max:
            update_state(x_prev, x_iter, alpha)
            res = newton.solve(x)
            newton_count += res.iterations
            did_work = res.iterations > 0
            if (not res.converged) or (not did_work):
                nfail += 1
                alpha /= 2
                x = x_prev if k == 1 else x_iter
                if nfail >= nfail_max:
                    rank_print(f"Giving up. T={T} alpha={alpha} k={k}")
                    break
                continue
            x = res.x
            lvpp_count += 1
            nrm = float(np.sqrt(max(float(l2c(x)), 0.0)))
            if verbose:
                rank_print(f"  k={k} newton={res.iterations} alpha={alpha} "
                           f"||c_k - c_(k-1)|| = {nrm:.3e}")
            if nrm < lvpp_tol:
                break
            if res.iterations <= 4:
                alpha *= 2
            elif res.iterations >= 10:
                alpha /= 2
            x_iter = x
            k += 1

        result.load_history.append(float(T))
        result.newton_per_step.append(newton_count)
        result.lvpp_per_step.append(lvpp_count)
        result.retries_per_step.append(nfail)
        result.max_damage_history.append(max_c(x))
        _emit(step, T, newton_count, lvpp_count)

        # broken-specimen detection (:289-294)
        if k == 1 and allclose(x, x_prev) and step > 0:
            result.broken = True
            rank_print("Specimen broken — terminating continuation")
            break
        if nfail >= nfail_max:
            break
        x_prev = x
        if checkpoint_path is not None and (step + 1) % checkpoint_every == 0:
            _save_ck(step + 1)

    x_host = from_shard(x)
    result.u = np.asarray(x_host[u_sl])
    result.c = np.asarray(x_host[c_sl])
    return result
