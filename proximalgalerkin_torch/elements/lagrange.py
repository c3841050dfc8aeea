"""Nodal Lagrange elements via orthonormal-basis Vandermonde construction.

Equivalent role to Basix's Lagrange tabulation under the reference (every
example builds `basix.ufl.element("Lagrange", cell, degree)`, e.g.
obstacle_pg.py:68). Nodes are generated entity-by-entity (vertices, then edge
interiors, then face/cell interiors) so dofmaps can associate dofs with mesh
entities for boundary conditions and inter-cell continuity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Tuple

import numpy as np
from scipy.special import roots_jacobi

from .cells import ReferenceCell, reference_cell
from .orthopoly import num_modes, tabulate_orthonormal


def _interval_interior_points(degree: int, variant: str) -> np.ndarray:
    """Interior node parameters on (0,1) for one edge, length degree-1."""
    if degree <= 1:
        return np.zeros((0,))
    if variant == "gll":
        # interior Gauss–Lobatto points: roots of P^{(1,1)}_{p-1}
        x, _ = roots_jacobi(degree - 1, 1.0, 1.0)
        return 0.5 * (x + 1.0)
    return np.arange(1, degree) / degree


def _simplex_interior_lattice(cell: ReferenceCell, degree: int) -> np.ndarray:
    """Strictly interior equispaced lattice points of a simplex."""
    d = cell.dim
    pts = []
    if d == 2:
        for i in range(1, degree):
            for j in range(1, degree - i):
                pts.append((i / degree, j / degree))
    elif d == 3:
        for i in range(1, degree):
            for j in range(1, degree - i):
                for k in range(1, degree - i - j):
                    pts.append((i / degree, j / degree, k / degree))
    return np.array(pts, dtype=np.float64).reshape(-1, d)


def _quad_interior_lattice(degree: int, variant: str, dim: int) -> np.ndarray:
    t = _interval_interior_points(degree, variant)
    if len(t) == 0:
        return np.zeros((0, dim))
    grids = np.meshgrid(*([t] * dim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


@dataclass(frozen=True)
class LagrangeElement:
    """Scalar nodal Lagrange element on a reference cell.

    Attributes:
      points: (ndof, dim) nodal points on the reference cell.
      entity_dofs[d][e]: dof indices associated with entity e of dimension d.
      discontinuous: if True the dofmap never shares dofs between cells (DG).
    """

    cell: ReferenceCell
    degree: int
    variant: str
    discontinuous: bool
    points: np.ndarray
    entity_dofs: Tuple[Tuple[Tuple[int, ...], ...], ...]
    _coeff: np.ndarray = field(repr=False)  # inverse Vandermonde (nmodes, ndof)

    @property
    def ndof(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.cell.dim

    def tabulate(self, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Values (npts, ndof) and gradients (npts, ndof, dim) at `pts`."""
        vals_o, grads_o = tabulate_orthonormal(self.cell.name, self.degree, pts)
        vals = vals_o.T @ self._coeff            # (npts, ndof)
        grads = np.einsum("mpd,mn->pnd", grads_o, self._coeff)
        return vals, grads

    def facet_dofs(self, facet: int) -> List[int]:
        """All dofs on the closure of reference facet `facet` (for BCs)."""
        fdim = self.cell.dim - 1
        fverts = self.cell.facets[facet]
        dofs: List[int] = []
        # vertices of the facet
        for v in fverts:
            dofs.extend(self.entity_dofs[0][v])
        # edges fully contained in the facet (3D) or the facet itself (2D)
        if fdim >= 1:
            for e, everts in enumerate(self.cell.edges):
                if set(everts) <= set(fverts):
                    dofs.extend(self.entity_dofs[1][e])
        if fdim == 2:
            dofs.extend(self.entity_dofs[2][facet])
        return dofs


def _build_lagrange(cell_name: str, degree: int, variant: str,
                    discontinuous: bool) -> LagrangeElement:
    cell = reference_cell(cell_name)
    d = cell.dim
    verts = cell.vertices

    points: List[np.ndarray] = []
    ent_dofs: List[List[List[int]]] = [[] for _ in range(d + 1)]
    counter = 0

    def add(dim_, pts_):
        nonlocal counter
        ids = list(range(counter, counter + len(pts_)))
        ent_dofs[dim_].append(ids)
        if len(pts_):
            points.append(np.atleast_2d(pts_))
        counter += len(pts_)

    if degree == 0:
        # single node at the barycenter; necessarily discontinuous
        for v in range(cell.num_vertices):
            ent_dofs[0].append([])
        for e in range(cell.num_edges):
            ent_dofs[1].append([])
        if d == 3:
            for f in range(cell.num_facets):
                ent_dofs[2].append([])
        add(d, verts.mean(axis=0)[None, :])
        discontinuous = True
    else:
        # vertices
        for v in range(cell.num_vertices):
            add(0, verts[v][None, :])
        # edge interiors
        t = _interval_interior_points(degree, variant)
        for (va, vb) in cell.edges:
            pts = verts[va][None, :] + t[:, None] * (verts[vb] - verts[va])[None, :]
            add(1, pts)
        # facet interiors (3D cells)
        if d == 3:
            for f, fverts in enumerate(cell.facets):
                fcell = reference_cell(cell.facet_cell)
                if fcell.name == "triangle":
                    ref = _simplex_interior_lattice(fcell, degree)
                else:
                    ref = _quad_interior_lattice(degree, variant, 2)
                if len(ref) == 0:
                    add(2, np.zeros((0, 3)))
                    continue
                # map facet-reference coords to 3D via the facet's vertices
                v0 = verts[fverts[0]]
                e1 = verts[fverts[1]] - v0
                e2 = verts[fverts[2]] - v0
                pts = v0[None, :] + ref[:, 0:1] * e1[None, :] + ref[:, 1:2] * e2[None, :]
                add(2, pts)
        # cell interior
        if cell.is_simplex:
            interior = _simplex_interior_lattice(cell, degree)
        else:
            interior = _quad_interior_lattice(degree, variant, d)
        add(d, interior if len(interior) else np.zeros((0, d)))

    pts = np.concatenate(points, axis=0) if points else np.zeros((0, d))
    nm = num_modes(cell_name, degree)
    assert pts.shape[0] == nm, (pts.shape, nm, cell_name, degree)

    vals_o, _ = tabulate_orthonormal(cell_name, degree, pts)
    V = vals_o.T  # (ndof, nmodes)
    condV = np.linalg.cond(V)
    if condV > 1e12:
        raise ValueError(
            f"ill-conditioned Vandermonde (cond={condV:.2e}) for {cell_name} "
            f"degree {degree} variant {variant}; use variant='gll'")
    coeff = np.linalg.inv(V)

    ent = tuple(tuple(tuple(ids) for ids in per_dim) for per_dim in ent_dofs)
    return LagrangeElement(cell=cell, degree=degree, variant=variant,
                           discontinuous=discontinuous, points=pts,
                           entity_dofs=ent, _coeff=coeff)


@lru_cache(maxsize=None)
def lagrange_element(cell_name: str, degree: int, variant: str = "equispaced",
                     discontinuous: bool = False) -> LagrangeElement:
    """Create (and cache) a scalar Lagrange element.

    degree=0 gives the DG0 element (used for the active-set indicator outputs,
    reference gradient_constraint_dolfinx.py:134-146).
    """
    return _build_lagrange(cell_name, degree, variant, discontinuous)
