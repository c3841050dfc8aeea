"""Frozen copies of the two mesh generators the cells run on.

The benchmark makes each cell's mesh itself and hands the same points
and cells to the program (as its `Mesh(cell_type, points, cells)`) and
to the plain reference. These are copies of the port's
`mesh/generation.rectangle_mesh` (right diagonals) and
`mesh/unstructured.create_disk_mesh`, kept here so that a change to the
program's generators cannot change what the benchmark measures; a CPU
test holds them point for point to the port's.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, cKDTree


def rectangle(nx: int, ny: int, p0=(0.0, 0.0), p1=(1.0, 1.0)):
    """(points (n, 2), cells (e, 3) int32): the structured nx x ny
    rectangle split along the right diagonal of each quad."""
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()

    def vid(i, j):
        return i * (ny + 1) + j

    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    cells = np.concatenate([np.stack([v00, v10, v11], axis=1),
                            np.stack([v00, v11, v01], axis=1)], axis=0)
    return pts, np.ascontiguousarray(cells, dtype=np.int32)


def _hex_lattice(bbox, h: float) -> np.ndarray:
    (x0, y0), (x1, y1) = bbox
    dy = h * np.sqrt(3) / 2
    rows = []
    y = y0
    row = 0
    while y <= y1 + 1e-12:
        xs = np.arange(x0 + (h / 2 if row % 2 else 0.0), x1 + 1e-12, h)
        rows.append(np.stack([xs, np.full_like(xs, y)], axis=1))
        y += dy
        row += 1
    return np.concatenate(rows, axis=0)


def _build(points: np.ndarray, inside_fn, n_boundary: int, smooth: int):
    """Delaunay, centroid filter and Laplacian smoothing of the points
    after the first n_boundary; returns (points, cells) without unused
    points."""

    def triangulate(pts):
        cells = Delaunay(pts).simplices
        return cells[inside_fn(pts[cells].mean(axis=1))]

    pts = points
    for _ in range(smooth + 1):
        cells = triangulate(pts)
        if smooth == 0:
            break
        neigh = {}
        for c in cells:
            for a in range(3):
                for b in range(3):
                    if a != b:
                        neigh.setdefault(c[a], set()).add(c[b])
        new = pts.copy()
        for i, ns in neigh.items():
            if i >= n_boundary:
                new[i] = pts[list(ns)].mean(axis=0)
        pts = new
        smooth -= 1
    cells = triangulate(pts)
    used = np.unique(cells)
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return pts[used], remap[cells]


def disk(res: float, radius: float = 1.0, smooth: int = 2):
    """(points, cells int32): example 01's uniform-resolution unit disk
    (generate_mesh_gmsh.py:12-43) at target edge length res."""
    c = np.zeros(2)
    nh = max(int(np.ceil(2 * np.pi * radius / res)), 12)
    ang = np.linspace(0, 2 * np.pi, nh, endpoint=False)
    circ = c[None, :] + radius * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    lat = _hex_lattice((c - radius, c + radius), res)
    d, _ = cKDTree(circ).query(lat)
    inside = np.linalg.norm(lat - c[None, :], axis=1) < radius - 1e-12
    lat = lat[(d > 0.6 * res) & inside]
    pts = np.concatenate([circ, lat], axis=0)

    def inside_c(x):
        return np.linalg.norm(x - c[None, :], axis=1) < radius + 1e-9

    P, C = _build(pts, inside_c, len(circ), smooth)
    return P, np.ascontiguousarray(C, dtype=np.int32)


def make(config: dict):
    """(points, cells) of a configuration: `mesh` "rectangle" with `n`,
    `p0`, `p1` (n x n cells), or "disk" with `res`."""
    if config["mesh"] == "rectangle":
        return rectangle(config["n"], config["n"], tuple(config["p0"]),
                         tuple(config["p1"]))
    if config["mesh"] == "disk":
        return disk(config["res"])
    raise ValueError(f"unknown mesh {config['mesh']!r}")
