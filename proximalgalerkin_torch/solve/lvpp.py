"""The LVPP (latent variable proximal point) outer loop.

The algorithmic core of the reference (SURVEY.md overview): proximal-point
iteration over a Newton-solved saddle system, with the reference's five
step-size schedules (constant / linear / doubling / geometric /
double-exponential; obstacle_pg.py:175-186, signorini_dolfinx.py:324-329,
multiphase_dolfinx.py:203-205) and the adaptive failure-retry state machine
of the fracture/eigenvalue/intersecting examples (fracture_dolfinx.py:220-284):
halve alpha + rollback on failure, grow on fast Newton convergence, shrink on
slow, give up after NFAIL_MAX failures. Commit-only-on-convergence semantics
(problem.py:120-123) are preserved: a failed inner solve never corrupts x_k.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..core.config import SolverOptions
from ..core.logging import PhaseTimer, count, rank_print, span
from .newton import NewtonResult, NewtonSolver
from .nonlinear import NonlinearProblem


@dataclass
class AlphaScheduler:
    """Step-size rules of the reference.

    constant:            alpha_k = C
    linear:              alpha_k = C + c * k
                         (gradient_constraint_dolfinx.py:175: alpha_0 + alpha_c*i)
    doubling:            alpha_k = C * 2^k
    geometric:           alpha_k = C * r^k
    double_exponential:  alpha_k = max(C * r^(q^k) - alpha_prev, C)
                         (obstacle_pg.py:177-183)
    All capped at alpha_max (obstacle --alpha-max default 1e5).
    """

    scheme: str = "constant"
    C: float = 1.0
    r: float = 1.5
    q: float = 1.5
    c: float = 1.0
    alpha_max: float = 1e5
    _prev_raw: float = field(default=1.0, repr=False)

    def reset(self):
        self._prev_raw = 1.0

    def value(self, k: int) -> float:
        s = self.scheme
        if s == "constant":
            a = self.C
        elif s == "linear":
            a = self.C + self.c * k
        elif s == "doubling":
            a = self.C * 2.0**k
        elif s == "geometric":
            a = self.C * self.r**k
        elif s == "double_exponential":
            try:
                a = max(self.C * self.r ** (self.q**k) - self._prev_raw, self.C)
            except OverflowError:
                a = self.alpha_max
            self._prev_raw = a
        else:
            raise ValueError(f"unknown alpha scheme {self.scheme!r}")
        return float(min(a, self.alpha_max))


@dataclass
class LVPPResult:
    x: torch.Tensor
    iterations: int
    converged: bool
    newton_steps: List[int] = field(default_factory=list)
    step_sizes: List[float] = field(default_factory=list)
    increments: List[float] = field(default_factory=list)
    observables: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def total_newton(self) -> int:
        return int(sum(self.newton_steps))

    def to_csv(self, path, extra: Optional[Mapping] = None) -> None:
        """Per-iteration record, mirroring the reference's pandas CSV of
        observable columns (obstacle_pg.py:244-260). `extra` adds constant
        columns (Polynomial order, dofs, Step size rule)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        n = len(self.newton_steps)
        cols = {**self.observables,
                "Newton steps": self.newton_steps,
                "Step sizes": self.step_sizes,
                "Primal increments": self.increments}
        for k, v in (extra or {}).items():
            cols[k] = [v] * n
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols.keys())
            for row in zip(*cols.values()):
                w.writerow(row)

    def to_jsonl(self, path, extra: Optional[Mapping] = None) -> None:
        """One JSON object per outer iteration (the structured-metrics
        sink alongside the CSV)."""
        import json as _json
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for k in range(len(self.newton_steps)):
                rec = {"iteration": k + 1,
                       "newton_steps": self.newton_steps[k],
                       "alpha": self.step_sizes[k],
                       "primal_increment": self.increments[k],
                       **{name: vals[k]
                          for name, vals in self.observables.items()},
                       **(extra or {})}
                f.write(_json.dumps(rec) + "\n")


class LVPPSolver:
    """Outer proximal-point driver.

    Args:
      problem: the nonlinear saddle problem; its residual must read the
        constants {"alpha"} and the coefficients produced by `prev_coeffs`.
      prev_coeffs: x_k -> coefficient dict injecting the previous iterate
        (e.g. {"sol_k": x_k} evaluated on a coefficient space).
      increment: (x, x_k) -> float, the outer convergence norm (H1 increment
        in the obstacle example, obstacle_pg.py:151,200).
      observables: {name: (x, x_k, alpha) -> float} recorded per iteration.
      adaptive: enable the fracture-style retry machine.
    """

    def __init__(self, problem: NonlinearProblem,
                 newton_options: Optional[Mapping] = None,
                 alpha: Optional[AlphaScheduler] = None,
                 prev_coeffs: Optional[Callable] = None,
                 increment: Optional[Callable] = None,
                 observables: Optional[Mapping[str, Callable]] = None,
                 tol: float = 1e-6,
                 max_iterations: int = 100,
                 adaptive: bool = False,
                 adaptive_grow: float = 2.0,
                 adaptive_shrink: float = 2.0,
                 grow_below_its: int = 4,
                 shrink_above_its: int = 10,
                 nfail_max: int = 50,
                 verbose: bool = True,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 1,
                 timer: Optional[PhaseTimer] = None):
        self.problem = problem
        # distributed problems (parallel.dofpart.DistributedLvppProblem)
        # manufacture their own distributed Newton; everything else
        # in this driver (alpha schedules, retry machine, observables,
        # checkpoints) is solver-agnostic
        make = getattr(problem, "make_newton_solver", None)
        if make is not None:
            self.newton = make(SolverOptions(newton_options or {}),
                               timer=timer)
        else:
            self.newton = NewtonSolver(problem,
                                       SolverOptions(newton_options or {}),
                                       timer=timer)
        self.alpha = alpha or AlphaScheduler()
        self.prev_coeffs = prev_coeffs or (lambda x_k: {})
        self.increment = increment
        self.observables = dict(observables or {})
        self.tol = tol
        self.max_iterations = max_iterations
        self.adaptive = adaptive
        self.adaptive_grow = adaptive_grow
        self.adaptive_shrink = adaptive_shrink
        self.grow_below_its = grow_below_its
        self.shrink_above_its = shrink_above_its
        self.nfail_max = nfail_max
        self.verbose = verbose
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        # the Newton solver's PhaseTimer (residual, assembly, host
        # transfer, LU, line search, Krylov)
        self.timer = getattr(self.newton, "timer", timer)

    def _save_checkpoint(self, x, x_k, k, alpha_scale, nfail, result):
        from ..utils.checkpoint import LVPPCheckpoint
        LVPPCheckpoint(
            x=x.cpu().numpy(), x_k=x_k.cpu().numpy(), iteration=k,
            alpha_prev_raw=self.alpha._prev_raw, alpha_scale=alpha_scale,
            nfail=nfail, newton_steps=result.newton_steps,
            step_sizes=result.step_sizes, increments=result.increments,
            observables=result.observables).save(self.checkpoint_path)

    def solve(self, x0, resume=None) -> LVPPResult:
        """Solve from x0, or resume from an LVPPCheckpoint (the root span
        `lvpp.solve`, one span `lvpp.step` an outer iteration)."""
        with span("lvpp.solve"):
            return self._solve(x0, resume)

    def _solve(self, x0, resume) -> LVPPResult:
        prob = self.problem
        x_k = prob.set_bc(x0)
        result = LVPPResult(x=x_k, iterations=0, converged=False,
                            observables={n: [] for n in self.observables})
        self.alpha.reset()
        nfail = 0
        alpha_scale = 1.0  # adaptive multiplier on the scheduled alpha

        k = 0
        if resume is not None:
            x_k = prob.set_bc(resume.x_k)
            k = resume.iteration
            self.alpha._prev_raw = resume.alpha_prev_raw
            alpha_scale = resume.alpha_scale
            nfail = resume.nfail
            result.newton_steps = list(resume.newton_steps)
            result.step_sizes = list(resume.step_sizes)
            result.increments = list(resume.increments)
            result.observables = {n: list(v)
                                  for n, v in resume.observables.items()}
            result.iterations = k
            result.x = x_k
        while k < self.max_iterations:
            with span("lvpp.step"):
                a = self.alpha.value(k) * alpha_scale
                prob.update(consts={"alpha": torch.tensor(
                    a, dtype=prob.form.dtype, device=prob.device)},
                            coeffs=self.prev_coeffs(x_k))
                if self.verbose:
                    rank_print(f"OUTER LOOP {k + 1} alpha: {a}")

                res: NewtonResult = self.newton.solve(x_k)
                solver_did_work = res.iterations > 0 or res.reason.converged

                if not res.converged or (self.adaptive
                                         and res.iterations == 0):
                    # failure path (fracture_dolfinx.py:243-264): halve
                    # alpha, roll back to the last committed iterate, retry
                    if not self.adaptive:
                        if self.verbose:
                            rank_print(f"  Newton diverged "
                                       f"({res.reason.name}); "
                                       "aborting outer loop")
                        result.x = x_k
                        return result
                    nfail += 1
                    if nfail > self.nfail_max:
                        rank_print("  retry budget exhausted")
                        result.x = x_k
                        return result
                    alpha_scale *= 0.5
                    if self.verbose:
                        rank_print(f"  solve failed ({res.reason.name}); "
                                   f"retrying with alpha scale {alpha_scale}")
                    continue

                x = res.x
                # a distributed problem's norm reduces over every subdomain
                norm = getattr(prob, "norm", torch.linalg.norm)
                count("host_reads")
                inc = (float(self.increment(x, x_k))
                       if self.increment is not None
                       else float(norm(x - x_k)))
                if self.verbose:
                    rank_print(f"Newton steps: {res.iterations}   "
                               f"Converged: {int(res.reason)}")
                    rank_print(f"Increment size: {inc}")

                result.newton_steps.append(res.iterations)
                result.step_sizes.append(a)
                result.increments.append(inc)
                for name, fn in self.observables.items():
                    count("host_reads")
                    result.observables[name].append(float(fn(x, x_k, a)))

                k += 1
                result.iterations = k
                # commit (only reached when converged)
                x_k = x
                result.x = x_k

                if inc < self.tol:
                    result.converged = True
                    break

                if self.adaptive:
                    if res.iterations <= self.grow_below_its:
                        alpha_scale *= self.adaptive_grow
                    elif res.iterations >= self.shrink_above_its:
                        alpha_scale /= self.adaptive_shrink

                # checkpoint AFTER the adaptive update: the saved alpha_scale
                # must be exactly what iteration k+1 will use, or a resumed
                # run walks a different alpha trajectory than the
                # uninterrupted one (caught by
                # test_checkpoint_resume_matches_uninterrupted)
                if self.checkpoint_path and k % self.checkpoint_every == 0:
                    self._save_checkpoint(x, x_k, k, alpha_scale, nfail,
                                          result)

        return result
