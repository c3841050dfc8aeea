"""Geometric multigrid V-cycle for structured-grid Schur operators.

The port of the reference package's la/gmg.py. It preconditions an SPD
operator

    S = free * (alpha A + m2d I) + (1 - free) I

on an (m, m) vertex grid: damped-Jacobi smoothing, full-weighting
restriction, bilinear prolongation, rediscretized coarse operators. Every
operation is a pad/slice stencil on torch tensors of the solve device;
the smoothing loops are Python loops of fixed length (no host read).

A is the 5-point stencil 4u - (N + S + E + W): on the uniform
right-diagonal triangulation the P1 hypotenuse couplings cancel, so the
stencil is h-independent in 2D; the diagonal m2d ~ c(x) M with M ~ h^2
restricts with a factor 4 per level. This is not the main path's
ops/mg.py (other grids, a variable coefficient, full weighting on
m = 2k + 1): its user is the lattice block-Schur preconditioner
(la/schur.py make_schur_mg_pc).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def stencil_apply(u, alpha, m2d, free):
    """S u on the (m, m) grid: alpha * A u + m2d * u on free points,
    identity elsewhere. The four neighbours are slices zero-padded back
    to the grid (F.pad's order: left, right, top, bottom)."""
    uf = torch.where(free, u, 0.0)
    Au = 4.0 * uf - (F.pad(uf[1:, :], (0, 0, 0, 1))
                     + F.pad(uf[:-1, :], (0, 0, 1, 0))
                     + F.pad(uf[:, 1:], (0, 1, 0, 0))
                     + F.pad(uf[:, :-1], (1, 0, 0, 0)))
    return torch.where(free, alpha * Au + m2d * u, u)


def restrict(r):
    """Full weighting to the (m//2+1, m//2+1) grid (m = 2k + 1)."""
    rp = F.pad(r, (1, 1, 1, 1))
    c = rp[1:-1:2, 1:-1:2]
    e = (rp[1:-1:2, 2::2] + rp[1:-1:2, :-2:2]
         + rp[2::2, 1:-1:2] + rp[:-2:2, 1:-1:2])
    d = (rp[2::2, 2::2] + rp[2::2, :-2:2]
         + rp[:-2:2, 2::2] + rp[:-2:2, :-2:2])
    return 0.25 * c + 0.125 * e + 0.0625 * d


def prolong(c, fine_shape):
    """Bilinear interpolation to the fine grid."""
    f = torch.zeros(tuple(fine_shape), dtype=c.dtype, device=c.device)
    f[::2, ::2] = c
    f[::2, 1::2] = 0.5 * (c[:, :-1] + c[:, 1:])
    f[1::2, ::2] = 0.5 * (c[:-1, :] + c[1:, :])
    f[1::2, 1::2] = 0.25 * (c[:-1, :-1] + c[:-1, 1:]
                            + c[1:, :-1] + c[1:, 1:])
    return f


def _coarse_free(free):
    """A coarse point is free only if its whole fine neighbourhood is;
    the coarse grid's boundary is never free."""
    cf = restrict(free.to(torch.float64)) > 0.999
    cf[0, :] = False
    cf[-1, :] = False
    cf[:, 0] = False
    cf[:, -1] = False
    return cf


def build_hierarchy(m2d, free, levels: int):
    """Per-level (m2d, free) grids; m2d scales by 4 per coarsening
    (M ~ h^2), free coarsens conservatively."""
    out = [(m2d, free)]
    cur_m2d, cur_free = m2d, free
    for _ in range(levels - 1):
        cur_m2d = 4.0 * restrict(cur_m2d)
        cur_free = _coarse_free(cur_free)
        out.append((cur_m2d, cur_free))
    return out


def _smooth(r, z, alpha, m2d, free, diag, sweeps, omega):
    for _ in range(sweeps):
        z = z + omega * (r - stencil_apply(z, alpha, m2d, free)) / diag
    return z


def _cycle(r, coeffs, nu, omega, recurse):
    """One V(nu, nu) cycle on the level of `coeffs`; recurse(rc) is the
    cycle of the next coarser level, or None on the coarsest."""
    alpha, m2d, free = coeffs
    diag = torch.where(free, 4.0 * alpha + m2d, 1.0)
    z = _smooth(r, torch.zeros_like(r), alpha, m2d, free, diag, nu, omega)
    if recurse is None:
        # coarsest level: extra smoothing
        return _smooth(r, z, alpha, m2d, free, diag, 24, omega)
    res = torch.where(free, r - stencil_apply(z, alpha, m2d, free), 0.0)
    # The stencil is the h^2-scaled Laplacian, so the coarse operator
    # represents 4x the fine scale: the restricted residual carries the
    # same factor 4
    zc = recurse(4.0 * restrict(res))
    z = z + torch.where(free, prolong(zc, r.shape), 0.0)
    return _smooth(r, z, alpha, m2d, free, diag, nu, omega)


def v_cycle(r, hierarchy, alpha, level=0, nu=2, omega=0.8):
    """One V(nu, nu) cycle for S z = r; returns z."""
    m2d, free = hierarchy[level]
    last = level == len(hierarchy) - 1
    return _cycle(r, (alpha, m2d, free), nu, omega,
                  None if last else
                  (lambda rc: v_cycle(rc, hierarchy, alpha, level + 1, nu,
                                      omega)))


def mg_levels_for(m: int, coarsest: int = 17) -> int:
    lv = 1
    while (m - 1) % 2 == 0 and (m - 1) // 2 + 1 >= coarsest:
        m = (m - 1) // 2 + 1
        lv += 1
    return lv


# ------------------------- variable-coefficient variant (lattice Schur PC)

def build_hierarchy_var(alpha, m2d, free, levels: int):
    """Per-level (alpha, m2d, free) for grid-varying alpha(x): alpha is
    h-independent (restricted plainly), m2d ~ h^2 (restricted with the
    factor 4), free coarsens conservatively."""
    out = [(alpha, m2d, free)]
    cur_a, cur_m2d, cur_free = alpha, m2d, free
    for _ in range(levels - 1):
        cur_a = restrict(cur_a)
        cur_m2d = 4.0 * restrict(cur_m2d)
        cur_free = _coarse_free(cur_free)
        out.append((cur_a, cur_m2d, cur_free))
    return out


def v_cycle_var(r, hierarchy, level=0, nu=2, omega=0.8):
    """V(nu, nu) cycle for (alpha(x) A + m2d) z = r — the S-solve of the
    lattice Schur preconditioner."""
    last = level == len(hierarchy) - 1
    return _cycle(r, hierarchy[level], nu, omega,
                  None if last else
                  (lambda rc: v_cycle_var(rc, hierarchy, level + 1, nu,
                                          omega)))


def lattice_map(points: np.ndarray):
    """Map dof coordinates that form a full 2D tensor lattice to grid
    indices. Returns (perm, shape): perm[grid_flat] = dof index, with
    shape (my, mx). Raises ValueError if the points are not a complete
    lattice.

    Lagrange-P2 dofs on a uniform right-diagonal triangulation and Q_p
    dofs on a uniform quad grid both form complete (p*N+1)^2 lattices."""
    pts = np.asarray(points)
    if pts.shape[1] != 2:
        raise ValueError("lattice_map: 2D points only")
    out = []
    idx = []
    for d in range(2):
        x = pts[:, d]
        xs = np.unique(np.round(x, 9))
        h = np.min(np.diff(xs)) if len(xs) > 1 else 1.0
        i = np.round((x - xs[0]) / h).astype(np.int64)
        n = int(i.max()) + 1
        if not np.allclose(xs[0] + i * h, x, atol=1e-8 * max(1.0, abs(h))):
            raise ValueError("lattice_map: points off-lattice")
        idx.append(i)
        out.append(n)
    mx, my = out
    flat = idx[1] * mx + idx[0]
    if len(np.unique(flat)) != mx * my or len(pts) != mx * my:
        raise ValueError("lattice_map: incomplete lattice")
    perm = np.empty(mx * my, dtype=np.int64)
    perm[flat] = np.arange(len(pts))
    return perm, (my, mx)
