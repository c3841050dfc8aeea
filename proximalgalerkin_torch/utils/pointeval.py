"""Point evaluation of FE functions at arbitrary physical points.

This package's equivalent of `interpolate_nonmatching` /
`create_interpolation_data` (reference monge_ampere_dolfinx.py:100-110) and
Firedrake's `.at()` sampling (intersecting_constraints_firedrake.py:147-171):
locate the containing cell (host-side), pull back to reference coordinates,
tabulate, and contract with the cell dofs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..spaces.space import FunctionSpace


def _reference_coords(mesh, cells, points):
    """Affine pullback of physical points to reference coordinates for
    simplex cells (per point, given its containing cell)."""
    verts = mesh.points[mesh.cell_vertices[cells]]    # (n, nv, gdim)
    v0 = verts[:, 0]
    T = np.stack([verts[:, i + 1] - v0 for i in range(mesh.tdim)], axis=-1)
    rhs = points - v0
    return np.linalg.solve(T, rhs[..., None])[..., 0]


def locate_cells(mesh, points: np.ndarray, tol: float = 1e-10) -> np.ndarray:
    """Containing cell of each point (brute force over candidate cells by
    bounding box, then barycentric test). points: (n, gdim)."""
    pts = np.atleast_2d(points)
    cells = np.full(len(pts), -1, dtype=np.int64)
    verts = mesh.points[mesh.cell_vertices]           # (e, nv, gdim)
    lo = verts.min(axis=1) - tol
    hi = verts.max(axis=1) + tol
    for i, p in enumerate(pts):
        cand = np.flatnonzero(np.all((lo <= p) & (p <= hi), axis=1))
        for c in cand:
            xi = _reference_coords(mesh, np.array([c]), p[None, :])[0]
            if mesh.ref_cell.is_simplex:
                ok = np.all(xi >= -tol) and xi.sum() <= 1 + tol
            else:
                ok = np.all((xi >= -tol) & (xi <= 1 + tol))
            if ok:
                cells[i] = c
                break
    return cells


def evaluate(space: FunctionSpace, z: np.ndarray, points: np.ndarray,
             cells: Optional[np.ndarray] = None) -> np.ndarray:
    """Evaluate the FE function with dof vector z at physical points.

    Returns (npts,) for scalar spaces or (npts, value_size)."""
    mesh = space.mesh
    pts = np.atleast_2d(np.asarray(points, float))
    if cells is None:
        cells = locate_cells(mesh, pts)
    if np.any(cells < 0):
        raise ValueError("point(s) outside the mesh")
    xi = _reference_coords(mesh, cells, pts)
    m = space.value_size
    z = np.asarray(z)
    out = np.zeros((len(pts), m))
    el = space.element
    for i, (c, x) in enumerate(zip(cells, xi)):
        vals, _ = el.tabulate(x[None, :])
        dofs = space.dofmap[c]
        for comp in range(m):
            out[i, comp] = vals[0] @ z[dofs * m + comp]
    return out[:, 0] if m == 1 else out


def interpolate_nonmatching(src_space: FunctionSpace, z: np.ndarray,
                            dst_space: FunctionSpace) -> np.ndarray:
    """Interpolate a function from one space into another (possibly of a
    different degree/mesh) by point evaluation at the destination's dof
    points — the p-/h-refinement warm start of Monge–Ampère
    (monge_ampere_dolfinx.py:100-110, monge_ampere_firedrake.py:70-71)."""
    vals = evaluate(src_space, z, dst_space.dof_points)
    m = dst_space.value_size
    if m == 1:
        return np.asarray(vals)
    return np.asarray(vals).reshape(-1)
