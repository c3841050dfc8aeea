"""Plain reference of the fast path: the optimality conditions of the
discrete obstacle problem that the P1 lumped LVPP converges to.

With A the P1 stiffness and phi the obstacle at the vertices, the
converged u solves the discrete variational inequality

    u >= phi,  A u >= 0,  (u - phi) . (A u) = 0   (interior vertices),

and the latent field satisfies u = phi + exp(psi). The reference
rebuilds A and phi from the benchmark's mesh and obstacle centre, and
judges each answer by two numbers:

  natural_residual  max over interior vertices of
                    |min(u - phi, (A u)_i / A_ii)|, zero exactly at the
                    solution (feasibility, sign of the multiplier and
                    complementarity in one number, in units of u);
  latent_gap        max over interior vertices of |u - phi - exp(psi)|.

Limits: between the program's readings over a dozen seeds and the
control's (the program's answer in float32; the program's own float32
path cannot end at 1024^2 and is read at small sizes) on an H100; see
PERF.md.
"""

from __future__ import annotations

import numpy as np

from pgbench.reference import _p1

LIMITS = {"natural_residual": 1e-9, "latent_gap": 1e-9}


def prepare(inputs, config: dict) -> dict:
    pts, cells = inputs.points, inputs.cells.astype(np.int64)
    n = len(pts)
    Ke = _p1.stiffness_elements(pts, cells)
    diag = np.bincount(cells.reshape(-1),
                       weights=np.einsum("eii->ei", Ke).reshape(-1),
                       minlength=n)
    interior = np.ones(n, dtype=bool)
    interior[_p1.boundary_vertices(cells, n)] = False
    return {"Ke": Ke, "cells": cells, "n": n, "diag": diag,
            "interior": interior, "phi": _p1.cap(pts.T, inputs.centre)}


def numbers(ctx: dict, fields: dict) -> dict:
    u, psi = fields["u"], fields["psi"]
    Au = _p1.apply_elements(ctx["Ke"], ctx["cells"], u, ctx["n"])
    gap = u - ctx["phi"]
    inner = ctx["interior"]
    nat = np.minimum(gap, Au / ctx["diag"])[inner]
    lat = (gap - np.exp(np.minimum(psi, 700.0)))[inner]
    return {"natural_residual": float(np.max(np.abs(nat))),
            "latent_gap": float(np.max(np.abs(lat)))}
