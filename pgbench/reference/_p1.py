"""Plain NumPy P1 pieces shared by the references: element geometry,
the stiffness and mass of linear triangles, the boundary vertices, and
the spherical cap. Nothing here comes from the program under test."""

from __future__ import annotations

import numpy as np
from scipy.special import roots_jacobi


def cap(x: np.ndarray, centre) -> np.ndarray:
    """Spherical cap r0 = 0.5 blended into its tangent cone at beta = 0.9
    (obstacle_pg.py:92-104), centred at `centre`; x is (2, npts)."""
    r = np.hypot(x[0] - centre[0], x[1] - centre[1])
    r0, beta = 0.5, 0.9
    b = r0 * beta
    t = np.sqrt(r0 * r0 - b * b)
    cone = (t + b * b / t) - b / t * r
    dome = np.sqrt(np.maximum(r0 * r0 - np.minimum(r, r0) ** 2, 0.0))
    return np.where(r > b, cone, dome)


def gradients(points: np.ndarray, cells: np.ndarray):
    """(area (e,), grads (e, 3, 2)) of the linear basis on each triangle."""
    p = points[cells]
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    g1 = np.stack([e2[:, 1], -e2[:, 0]], axis=1) / det[:, None]
    g2 = np.stack([-e1[:, 1], e1[:, 0]], axis=1) / det[:, None]
    return 0.5 * np.abs(det), np.stack([-(g1 + g2), g1, g2], axis=1)


def stiffness_elements(points, cells) -> np.ndarray:
    area, g = gradients(points, cells)
    return np.einsum("eid,ejd,e->eij", g, g, area)


def boundary_vertices(cells: np.ndarray, n: int) -> np.ndarray:
    """Vertices on edges that belong to one triangle only."""
    e = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                        cells[:, [2, 0]]]).astype(np.int64)
    e.sort(axis=1)
    key, count = np.unique(e[:, 0] * n + e[:, 1], return_counts=True)
    lone = key[count == 1]
    return np.unique(np.concatenate([lone // n, lone % n]))


def apply_elements(Ke: np.ndarray, cells: np.ndarray, v: np.ndarray,
                   n: int) -> np.ndarray:
    """Sum over cells of Ke @ v[cell] into the vertices."""
    y = np.einsum("eij,ej->ei", Ke, v[cells])
    return np.bincount(cells.reshape(-1), weights=y.reshape(-1),
                       minlength=n)


def triangle_rule(degree: int):
    """Conical product (Stroud) rule on the unit triangle, exact to
    `degree`: Gauss-Legendre in a, Gauss-Jacobi(1, 0) in b,
    (x, y) = (a (1 - b), b). Weights sum to 1/2."""
    n = degree // 2 + 1
    a, wa = np.polynomial.legendre.leggauss(n)
    a, wa = 0.5 * (a + 1.0), 0.5 * wa
    b, wb = roots_jacobi(n, 1.0, 0.0)
    b, wb = 0.5 * (b + 1.0), wb / 4.0
    A, B = np.meshgrid(a, b, indexing="ij")
    pts = np.stack([(A * (1.0 - B)).ravel(), B.ravel()], axis=1)
    return pts, np.outer(wa, wb).ravel()
