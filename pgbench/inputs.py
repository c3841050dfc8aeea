"""The one generator of the benchmark's inputs.

A workload file's `params` and the run's seed give the
problem data: the obstacle is the reference's spherical cap (r0 = 0.5,
beta = 0.9, f = 0; obstacle_pg.py:92-104, obstacle_finite_difference
.jl:13-27) with its centre moved from the origin to a point drawn from
the seed, uniformly in a disc of radius `centre_radius`. The same seed
gives the same inputs; the radius is small, so every seed asks for
nearly the same work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import meshes


def spherical_cap(x: np.ndarray, centre=(0.0, 0.0)) -> np.ndarray:
    """The cap of radius r0 = 0.5 blended into its tangent cone, centred
    at `centre`; x has shape (2, npts)."""
    r = np.sqrt((x[0] - centre[0]) ** 2 + (x[1] - centre[1]) ** 2)
    r0, beta = 0.5, 0.9
    b = r0 * beta
    tmp = np.sqrt(r0**2 - b**2)
    B = tmp + b * b / tmp
    C = -b / tmp
    outside = B + r * C
    inside = np.sqrt(np.maximum(r0**2 - np.minimum(r, r0) ** 2, 0.0))
    return np.where(r > b, outside, inside)


@dataclass
class Inputs:
    seed: int
    points: np.ndarray         # (n, 2) mesh vertices
    cells: np.ndarray          # (e, 3) int32 triangles
    centre: tuple              # the obstacle's centre

    def obstacle(self, x: np.ndarray) -> np.ndarray:
        return spherical_cap(x, self.centre)


def centre_of(seed: int, radius: float) -> tuple:
    """A point uniform in the disc of `radius` about the origin, drawn
    from the seed (any whole number)."""
    rng = np.random.default_rng(int(seed) % 2**63)
    rho = radius * np.sqrt(rng.random())
    theta = 2.0 * np.pi * rng.random()
    return (float(rho * np.cos(theta)), float(rho * np.sin(theta)))


def make(config: dict, params: dict, seed: int) -> Inputs:
    """The inputs of a configuration under a workload's parameters."""
    points, cells = meshes.make(config)
    return Inputs(seed, points, cells,
                  centre_of(seed, float(params["centre_radius"])))
