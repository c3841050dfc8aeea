"""Parametric geometries with graded resolution (gmsh-OCC replacement).

Rebuilds the specific geometries src/lvpp/mesh_generation.py produces with
gmsh: the half-disk contact specimen (create_half_disk, :11-83) with
resolution graded from `res` at the contact arc to ~20x coarser away from
it (threshold field :57-64). Graded interior point clouds come from greedy
Poisson-disk-style thinning of a fine lattice against a spacing function,
followed by filtered Delaunay and Lloyd smoothing (mesh/unstructured.py
machinery).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
from scipy.spatial import cKDTree

from .mesh import Mesh
from .unstructured import TaggedMesh, _build, _hex_lattice, _tag_boundary


def _greedy_thin(cands: np.ndarray, h_fn: Callable, seed_pts: np.ndarray
                 ) -> np.ndarray:
    """Keep candidates so that no two kept points are closer than
    ~0.85 * h(midpoint); seeded with fixed boundary points."""
    h_c = h_fn(cands)
    order = np.argsort(h_c)     # fill fine regions first
    cell = {}

    def key(p, h):
        return (int(p[0] // h), int(p[1] // h))

    kept = []
    base = float(h_c.min())

    # spatial hash at the finest spacing
    def insert(p):
        k = key(p, base)
        cell.setdefault(k, []).append(p)

    def near(p, r):
        k0, k1 = key(p, base)
        rr = int(np.ceil(r / base)) + 1
        for a in range(k0 - rr, k0 + rr + 1):
            for b in range(k1 - rr, k1 + rr + 1):
                for q in cell.get((a, b), ()):
                    if (p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2 < r * r:
                        return True
        return False

    for p in seed_pts:
        insert(p)
    for i in order:
        p = cands[i]
        r = 0.85 * h_c[i]
        if not near(p, r):
            insert(p)
            kept.append(p)
    return np.array(kept).reshape(-1, 2)


def _sample_curve(param_fn, t0, t1, h_fn, max_pts=100000) -> np.ndarray:
    """Adaptively sample a curve with local spacing h(point)."""
    pts = [np.asarray(param_fn(t0), float)]
    t = t0
    # estimate of d|curve|/dt by finite difference
    while t < t1 and len(pts) < max_pts:
        p = np.asarray(param_fn(t), float)
        dt = 1e-6 * (t1 - t0)
        speed = np.linalg.norm(
            np.asarray(param_fn(min(t + dt, t1))) - p) / dt
        h = float(h_fn(p[None, :])[0])
        t = t + h / max(speed, 1e-12)
        if t >= t1:
            break
        pts.append(np.asarray(param_fn(t), float))
    return np.array(pts)


def create_half_disk(c_y: float = 0.5, R: float = 0.5, res: float = 0.04,
                     coarsening: float = 20.0, smooth: int = 2
                     ) -> TaggedMesh:
    """Lower half-disk: center (0, c_y), radius R, flat top at y = c_y
    (region 'displacement'), curved arc below (region 'contact'), with
    resolution res at the arc growing to coarsening*res away from it
    (mesh_generation.py:11-64)."""
    center = np.array([0.0, c_y])

    def arc_dist(x):
        return np.abs(np.linalg.norm(x - center[None, :], axis=1) - R) \
            + np.maximum(c_y - 1e9, 0) * 0  # distance to full circle; the
        # relevant region is below the center line where the arc lives

    def h_fn(x):
        d = arc_dist(np.atleast_2d(x))
        t = np.clip((d - 0.075 * R) / (0.425 * R), 0.0, 1.0)
        return res * (1.0 + (coarsening - 1.0) * t)

    # boundary: arc from (-R, c_y) to (R, c_y) through the bottom
    arc = _sample_curve(
        lambda t: center + R * np.array([np.cos(t), np.sin(t)]),
        np.pi, 2.0 * np.pi, h_fn)
    # flat top sampled right-to-left with graded spacing
    top = _sample_curve(
        lambda t: np.array([R - t, c_y]), 0.0, 2.0 * R, h_fn)
    boundary = np.concatenate([arc, top], axis=0)
    # dedupe near corners
    tree = cKDTree(boundary)
    pairs = tree.query_pairs(0.3 * res)
    drop = {max(a, b) for a, b in pairs}
    boundary = boundary[[i for i in range(len(boundary)) if i not in drop]]

    def inside(x):
        r = np.linalg.norm(x - center[None, :], axis=1)
        return (r < R - 1e-12) & (x[:, 1] < c_y - 1e-12)

    lat = _hex_lattice((center - R, np.array([R, c_y])), res)
    cands = lat[inside(lat)]
    btree = cKDTree(boundary)
    d, _ = btree.query(cands)
    cands = cands[d > 0.5 * res]
    interior = _greedy_thin(cands, h_fn, boundary)

    pts = np.concatenate([boundary, interior], axis=0)

    def inside_c(x):
        r = np.linalg.norm(x - center[None, :], axis=1)
        return (r < R + 1e-9) & (x[:, 1] < c_y + 1e-9)

    P, C = _build(pts, inside_c, cKDTree(boundary), res, smooth=smooth)
    mesh = Mesh("triangle", P, C)

    def dist_top(x):
        return np.abs(x[:, 1] - c_y)

    def dist_arc(x):
        return np.abs(np.linalg.norm(x - center[None, :], axis=1) - R)

    return _tag_boundary(mesh, [("displacement", dist_top),
                                ("contact", dist_arc)])


def create_half_sphere(c_z: float = 0.5, R: float = 0.5,
                       res: float = 0.1) -> TaggedMesh:
    """Lower half-ball in 3D: center (0, 0, c_z), radius R, flat top at
    z = c_z ('displacement'), spherical surface below ('contact') — the
    3D Signorini specimen (mesh_generation.py:86-168).

    Tet mesh via filtered 3D Delaunay of a boundary-sampled + BCC-lattice
    point cloud (slivers mostly sit at the curved boundary and are
    harmless under a direct solve)."""
    from scipy.spatial import Delaunay as Delaunay3

    center = np.array([0.0, 0.0, c_z])

    # surface sampling: Fibonacci lower hemisphere
    n_surf = max(int(4.0 * np.pi * R * R / (res * res) / 2), 64)
    k = np.arange(n_surf)
    golden = (1 + 5 ** 0.5) / 2
    zs = -1.0 + (k + 0.5) / n_surf          # z in (-1, 0): lower hemisphere
    ths = 2 * np.pi * k / golden
    rr = np.sqrt(np.maximum(1 - zs ** 2, 0.0))
    sphere = center + R * np.stack(
        [rr * np.cos(ths), rr * np.sin(ths), zs], axis=1)

    # flat top: concentric rings
    top = [np.array([0.0, 0.0, c_z])]
    nr = max(int(R / res), 2)
    for i in range(1, nr + 1):
        ri = R * i / nr
        nth = max(int(2 * np.pi * ri / res), 6)
        th = np.linspace(0, 2 * np.pi, nth, endpoint=False)
        top.append(np.stack([ri * np.cos(th), ri * np.sin(th),
                             np.full(nth, c_z)], axis=1))
    top = np.concatenate([np.atleast_2d(t) for t in top], axis=0)
    # drop top points essentially on the rim (they belong to the sphere set)
    top = top[np.linalg.norm(top[:, :2], axis=1) < R - 0.3 * res]

    boundary = np.concatenate([sphere, top], axis=0)

    def inside(x):
        r = np.linalg.norm(x - center[None, :], axis=1)
        return (r < R - 1e-12) & (x[:, 2] < c_z - 1e-12)

    # interior BCC lattice
    g = np.arange(-R, R + res, res)
    X, Y, Z = np.meshgrid(g, g, g + c_z - R, indexing="ij")
    lat = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    lat2 = lat + res / 2.0
    cand = np.concatenate([lat, lat2], axis=0)
    cand = cand[inside(cand)]
    tree = cKDTree(boundary)
    d, _ = tree.query(cand)
    cand = cand[d > 0.55 * res]

    pts = np.concatenate([boundary, cand], axis=0)
    tri = Delaunay3(pts)
    cells = tri.simplices
    cent = pts[cells].mean(axis=1)
    rc = np.linalg.norm(cent - center[None, :], axis=1)
    keep = (rc < R) & (cent[:, 2] < c_z)
    cells = cells[keep]

    # drop fully-degenerate tets (zero volume)
    p = pts[cells]
    vol = np.abs(np.einsum(
        "ij,ij->i",
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
        p[:, 3] - p[:, 0])) / 6.0
    cells = cells[vol > 1e-14 * res ** 3]

    used = np.unique(cells)
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    mesh = Mesh("tetrahedron", pts[used], remap[cells].astype(np.int32))

    def dist_top(x):
        return np.abs(x[:, 2] - c_z)

    def dist_sphere(x):
        return np.abs(np.linalg.norm(x - center[None, :], axis=1) - R)

    return _tag_boundary(mesh, [("displacement", dist_top),
                                ("contact", dist_sphere)])


def create_ball_mesh(R: float = 1.0, res: float = 0.2,
                     center=(0.0, 0.0, 0.0)) -> Mesh:
    """Solid ball tet mesh — the 3D domain of MFEM's data/ball-nurbs.mesh
    that the reference's parallel eikonal runs on (ex40p,
    .github/workflows/test_mfem.yml:31-36). Fibonacci-sphere surface
    sampling + BCC interior lattice + filtered Delaunay (the
    create_half_sphere construction without the flat top)."""
    from scipy.spatial import Delaunay as Delaunay3

    c = np.asarray(center, float)
    n_surf = max(int(4.0 * np.pi * R * R / (res * res)), 64)
    k = np.arange(n_surf)
    golden = (1 + 5 ** 0.5) / 2
    zs = -1.0 + 2.0 * (k + 0.5) / n_surf
    ths = 2 * np.pi * k / golden
    rr = np.sqrt(np.maximum(1 - zs ** 2, 0.0))
    sphere = c + R * np.stack(
        [rr * np.cos(ths), rr * np.sin(ths), zs], axis=1)

    def inside(x):
        return np.linalg.norm(x - c[None, :], axis=1) < R - 1e-12

    g = np.arange(-R, R + res, res)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    lat = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1) + c
    cand = np.concatenate([lat, lat + res / 2.0], axis=0)
    cand = cand[inside(cand)]
    tree = cKDTree(sphere)
    d, _ = tree.query(cand)
    cand = cand[d > 0.55 * res]

    pts = np.concatenate([sphere, cand], axis=0)
    tri = Delaunay3(pts)
    cells = tri.simplices
    cent = pts[cells].mean(axis=1)
    cells = cells[np.linalg.norm(cent - c[None, :], axis=1) < R]
    p = pts[cells]
    vol = np.abs(np.einsum(
        "ij,ij->i",
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
        p[:, 3] - p[:, 0])) / 6.0
    cells = cells[vol > 1e-14 * res ** 3]

    used = np.unique(cells)
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return Mesh("tetrahedron", pts[used], remap[cells].astype(np.int32))
