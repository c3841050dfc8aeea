"""Plain reference of the distributed obstacle cell: the same first LVPP
step of the undistributed problem, in NumPy and SciPy, with exact
directions from a host sparse LU. The subdomains are the program's
business: a domain-decomposed solve of a problem has the answer of the
undistributed one, to the accuracy of its Krylov solves.

The problem, its assembly and the LVPP iteration are those of the disk's
reference (`obstacle_disk.Disk` and `lvpp`, which take any P1 triangle
mesh): P1 u and psi on the benchmark's 224 x 224 rectangle, the cap
moved by the seed, f = 0, u = 0 on the boundary, the configured
quadrature; `max_outer` LVPP steps from zeros, alpha by the
double-exponential rule. Each step's Newton (no line search) stops when
|F| <= snes_rtol |F_0|: the distributed Newton has no step-length test,
so the reference takes none (`snes_stol` 0; in float32, the control,
the disk's floor of 16 machine epsilons holds).

  u_gap       max |u - u_ref| / max |u_ref|
  latent_gap  max |exp(psi) - exp(psi_ref)| / max |u_ref|

Limits, from the program's readings on an H100 (12 seeds, two solves
each, every one outer 1 and Newton [5]) and the controls' (3 seeds):
the program's answer rounded to float32, and this reference in float32
(the program's own float32 path was not run: its GMRES target, a
relative residual of 1e-11, lies below float32's precision). See
PERF.md section 4.

  u_gap       program's worst 3.44e-14; rounded to float32 5.61e-8,
              the reference in float32 1.78e-6 to 2.04e-6. Limit 1e-10:
              2,900 times the worst reading (the record's own
              distributed run was within 3.1e-13 of host LU), 560 times
              under the nearest control.
  latent_gap  program's worst 4.07e-13; rounded to float32 9.43e-8 to
              9.71e-8, the reference in float32 2.40e-6 to 2.72e-6.
              Limit 1e-10: 246 times the worst reading, 940 times under
              the nearest control.
"""

from __future__ import annotations

import numpy as np

from pgbench.reference import obstacle_disk

LIMITS = {"u_gap": 1e-10, "latent_gap": 1e-10}

# one answer's gaps to the reference's solution, as for the disk
numbers = obstacle_disk.numbers


def newton_options(config: dict) -> dict:
    o = config["newton"]
    return {"snes_rtol": float(o["snes_rtol"]),
            "snes_atol": float(o["snes_atol"]), "snes_stol": 0.0,
            "snes_max_it": int(o["snes_max_it"])}


def solve(inputs, config: dict, dtype=np.float64) -> dict:
    lv = config["lvpp"]
    mesh = obstacle_disk.Disk(inputs.points, inputs.cells, inputs.centre,
                lv["quadrature_degree"], dtype)
    return obstacle_disk.lvpp(mesh, lv, newton_options(config))


def prepare(inputs, config: dict) -> dict:
    """The reference's own solution of the cell's problem."""
    return solve(inputs, config)
