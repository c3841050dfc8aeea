"""Structured mesh generators.

Replaces `dolfinx.mesh.create_unit_square/cube/rectangle/interval` (used by
examples 04/05/06/07/08/10, e.g. multiphase_dolfinx.py:34 with crossed
diagonals) with numpy generators producing SoA meshes. Parametric
gmsh-equivalent geometries (graded disk, half-sphere, crack polygon) live in
mesh/parametric.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .mesh import Mesh


def interval_mesh(n: int, a: float = 0.0, b: float = 1.0) -> Mesh:
    pts = np.linspace(a, b, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh("interval", pts, cells)


def unit_interval_mesh(n: int) -> Mesh:
    return interval_mesh(n)


def rectangle_mesh(nx: int, ny: int,
                   p0: Tuple[float, float] = (0.0, 0.0),
                   p1: Tuple[float, float] = (1.0, 1.0),
                   cell_type: str = "triangle",
                   diagonal: str = "right") -> Mesh:
    """Structured rectangle mesh.

    diagonal: 'right' | 'left' | 'crossed' (crossed matches the reference's
    CellType selection for multiphase, multiphase_dolfinx.py:34).
    """
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10, v01, v11 = vid(I, J), vid(I + 1, J), vid(I, J + 1), vid(I + 1, J + 1)

    # closed-form boundary vertex ids (Mesh.boundary_vertices fast path)
    gi, gj = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), indexing="ij")
    on_b = (gi == 0) | (gi == nx) | (gj == 0) | (gj == ny)
    bverts = vid(gi[on_b], gj[on_b]).astype(np.int64)
    bverts.sort()

    if cell_type == "quadrilateral":
        cells = np.stack([v00, v10, v01, v11], axis=1)
        m = Mesh("quadrilateral", pts, cells)
        m._boundary_vertices_hint = bverts
        return m

    if diagonal == "right":
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
        cells = np.concatenate([t1, t2], axis=0)
    elif diagonal == "left":
        t1 = np.stack([v00, v10, v01], axis=1)
        t2 = np.stack([v10, v11, v01], axis=1)
        cells = np.concatenate([t1, t2], axis=0)
    elif diagonal == "crossed":
        # add cell-center vertices; 4 triangles per quad
        centers = 0.25 * (pts[v00] + pts[v10] + pts[v01] + pts[v11])
        c0 = pts.shape[0]
        pts = np.concatenate([pts, centers], axis=0)
        vc = c0 + np.arange(len(I))
        t1 = np.stack([v00, v10, vc], axis=1)
        t2 = np.stack([v10, v11, vc], axis=1)
        t3 = np.stack([v11, v01, vc], axis=1)
        t4 = np.stack([v01, v00, vc], axis=1)
        cells = np.concatenate([t1, t2, t3, t4], axis=0)
    else:
        raise ValueError(diagonal)
    m = Mesh("triangle", pts, cells)
    m._boundary_vertices_hint = bverts
    return m


def unit_square_mesh(nx: int, ny: int, cell_type: str = "triangle",
                     diagonal: str = "right") -> Mesh:
    return rectangle_mesh(nx, ny, cell_type=cell_type, diagonal=diagonal)


def box_mesh(nx: int, ny: int, nz: int,
             p0: Tuple[float, float, float] = (0.0, 0.0, 0.0),
             p1: Tuple[float, float, float] = (1.0, 1.0, 1.0),
             cell_type: str = "tetrahedron") -> Mesh:
    """Structured box mesh (6 tets per hex Kuhn subdivision, or hexes)."""
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    z = np.linspace(p0[2], p1[2], nz + 1)
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    v = {}
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                v[(di, dj, dk)] = vid(I + di, J + dj, K + dk)

    if cell_type == "hexahedron":
        cells = np.stack([v[0, 0, 0], v[1, 0, 0], v[0, 1, 0], v[1, 1, 0],
                          v[0, 0, 1], v[1, 0, 1], v[0, 1, 1], v[1, 1, 1]], axis=1)
        return Mesh("hexahedron", pts, cells)

    # Kuhn triangulation: 6 tets around the main diagonal (0,0,0)-(1,1,1)
    paths = [((1, 0, 0), (1, 1, 0)), ((1, 0, 0), (1, 0, 1)),
             ((0, 1, 0), (1, 1, 0)), ((0, 1, 0), (0, 1, 1)),
             ((0, 0, 1), (1, 0, 1)), ((0, 0, 1), (0, 1, 1))]
    tets = [np.stack([v[0, 0, 0], v[a], v[b], v[1, 1, 1]], axis=1)
            for a, b in paths]
    cells = np.concatenate(tets, axis=0)
    return Mesh("tetrahedron", pts, cells)


def unit_cube_mesh(nx: int, ny: int, nz: int,
                   cell_type: str = "tetrahedron") -> Mesh:
    return box_mesh(nx, ny, nz, cell_type=cell_type)
