"""Quadrature rules on reference cells (host-side numpy).

Covers the degrees the reference examples request: up to 6 for the obstacle
problem (obstacle_pg.py:106), 10 for gradient constraints
(gradient_constraint_dolfinx.py:53), and 20 for the eigenvalue-constraint
example (eigenvalue_constraints_dolfinx.py:70). Simplex rules use collapsed
(Duffy) Gauss–Jacobi products, which are exact at any requested degree.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.special import roots_jacobi


def gauss_legendre_01(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss–Legendre rule on [0,1] (exact to degree 2n-1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _gauss_jacobi_01(n: int, alpha: float) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss–Jacobi rule on [0,1] with weight (1-x)^alpha."""
    x, w = roots_jacobi(n, alpha, 0.0)
    # map [-1,1] -> [0,1]; weight (1-x)^alpha dx -> ((1-t)*2)^alpha * dt/... :
    # t = (x+1)/2, (1-x)^alpha dx = (2(1-t))^alpha * 2 dt
    t = 0.5 * (x + 1.0)
    wt = w / (2.0 ** (alpha + 1))
    return t, wt


def cell_quadrature(cell_name: str, degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Points (nq, dim) and weights (nq,) integrating polynomials of total
    degree `degree` exactly over the unit reference cell."""
    degree = max(int(degree), 0)
    n = degree // 2 + 1
    if cell_name == "point":
        return np.zeros((1, 0)), np.ones(1)
    if cell_name == "interval":
        x, w = gauss_legendre_01(n)
        return x[:, None], w
    if cell_name == "quadrilateral":
        x, w = gauss_legendre_01(n)
        X, Y = np.meshgrid(x, x, indexing="ij")
        W = np.outer(w, w)
        return np.stack([X.ravel(), Y.ravel()], axis=1), W.ravel()
    if cell_name == "hexahedron":
        x, w = gauss_legendre_01(n)
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        W = np.einsum("i,j,k->ijk", w, w, w)
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1), W.ravel()
    if cell_name == "triangle":
        # Duffy: (x, y) = (a(1-b), b); dx dy = (1-b) da db. Gauss–Jacobi in b
        # with alpha=1 absorbs the (1-b) factor exactly.
        a, wa = gauss_legendre_01(n)
        b, wb = _gauss_jacobi_01(n, 1.0)
        A, B = np.meshgrid(a, b, indexing="ij")
        W = np.outer(wa, wb)
        pts = np.stack([(A * (1.0 - B)).ravel(), B.ravel()], axis=1)
        return pts, W.ravel()
    if cell_name == "tetrahedron":
        # (x,y,z) = (a(1-b)(1-c), b(1-c), c); Jacobian (1-b)(1-c)^2.
        a, wa = gauss_legendre_01(n)
        b, wb = _gauss_jacobi_01(n, 1.0)
        c, wc = _gauss_jacobi_01(n, 2.0)
        A, B, C = np.meshgrid(a, b, c, indexing="ij")
        W = np.einsum("i,j,k->ijk", wa, wb, wc)
        pts = np.stack([
            (A * (1.0 - B) * (1.0 - C)).ravel(),
            (B * (1.0 - C)).ravel(),
            C.ravel()], axis=1)
        return pts, W.ravel()
    raise ValueError(f"no quadrature for cell {cell_name!r}")
