"""Schur-complement block preconditioning for 2x2 saddle systems.

The port of the reference package's la/schur.py, the MFEM eikonal
solver's MINRES + BlockDiagonalPreconditioner recipe
(examples/09_eikonal/ex40.cpp:261-281):

    A = [[A00, A01], [A10, A11]]          (A10 = A01^T, symmetric)
    S = A10 diag(A00)^{-1} A01  (- A11)   (Mult_AtDA, ex40.cpp:265)
    P = blockdiag( diag(A00)^{-1},  approx-solve(S) )

The S-solve is a fixed Chebyshev polynomial in diag(S)^{-1} S (a fixed
linear SPD operator, as MINRES requires of its preconditioner), or one
lattice multigrid V-cycle (make_schur_mg_pc, la/gmg.py).

Blocks are identified by a component mask m0 over the global dof vector,
so "block0" can be any field — for the eikonal system block0 is the latent
psi block, whose diagonal (the Hellinger-map derivative mass matrix) is
the invertible one.

Everything here is a function of ELL data (la/ell.py) on the solve
device; every scalar it computes (the block0 sign, lmax, the Chebyshev
coefficients) stays a device tensor, so applying the preconditioner
inside a Krylov loop never reads the host. The 1e-300 guards compare in
the data's dtype, where 1e-300 is 0 in float32, as in the reference.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch


def schur_diag(ell, data, m0, dinv0, bc1):
    """Exact diagonal of S~ = A10 diag(A00)^{-1} A01 - A11 + 2 diag(bc1).

    By symmetry diag(S)_i = sum_{j in block0} A[i,j]^2 / d0[j] - A[i,i]
    for rows i in block1 — one masked ELL row reduction."""
    cols = ell.arrays["ell_cols"]
    quad = torch.sum(data * data * m0[cols] * dinv0[cols], dim=1)
    diagA = ell.diagonal(data)
    m1 = 1.0 - m0
    return m1 * (quad - diagA) + 2.0 * bc1


def _power_lmax(Sv: Callable, dinv, m1, iters: int):
    """Largest eigenvalue estimate of diag(S)^{-1} S on the block1
    subspace by power iteration from the reference's deterministic start
    (in the data's dtype); a 0-dim device tensor."""
    n = dinv.shape[0]
    v = m1 * (1.0 + 0.5 * torch.sin(torch.arange(n, dtype=dinv.dtype,
                                                 device=dinv.device)))
    v = v / torch.linalg.norm(v)
    lam = torch.ones((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        w = dinv * Sv(v)
        lam = torch.linalg.norm(w)
        v = w / torch.clamp(lam, min=1e-300)
    return lam


def cheb_solve(Sv: Callable, dinv, lmin, lmax, b, steps: int):
    """Fixed-step preconditioned Chebyshev iteration for S z = b with the
    spectrum of diag(S)^{-1} S in [lmin, lmax] — the classical recurrence
    (Saad, Iterative Methods, Alg. 12.1), a fixed SPD polynomial in S."""
    d_ = (lmax + lmin) / 2.0
    c = (lmax - lmin) / 2.0
    r = b
    p = dinv * r
    alpha = 1.0 / d_
    z = torch.zeros_like(b) + alpha * p
    r = r - alpha * Sv(p)
    for _ in range(steps - 1):
        beta = (c * alpha / 2.0) ** 2
        alpha = 1.0 / (d_ - beta / alpha)
        p = dinv * r + beta * p
        z = z + alpha * p
        r = r - alpha * Sv(p)
    return z


def schur_operator(ell, data, m0, bc1):
    """The SPD Schur operator on block1 and its exact diagonal.

    Returns (Sv, dS, dinv0): Sv the matrix-free action, dS its diagonal
    (both sign-corrected SPD), dinv0 the inverse block0 diagonal.

    Orientation: with block0 diagonal POSITIVE (eikonal's Hellinger-
    derivative mass), S~ = A10 d0^-1 A01 - A11 is the SPD Schur; with
    block0 NEGATIVE (the gradient constraint's latent row grad u - map),
    the SPD Schur is its negation. One dominant-sign flip, kept on the
    device, covers both."""
    m1 = 1.0 - m0
    diagA = ell.diagonal(data)
    d0 = m0 * diagA + m1                       # 1.0 off-block: safe divide
    dinv0 = torch.where(torch.abs(d0) > 1e-300, 1.0 / d0, 1.0)
    s0 = torch.sign(torch.sum(m0 * diagA))
    s0 = torch.where(s0 == 0, 1.0, s0)

    def Sv(v):
        t = ell.spmv(data, m1 * v)             # A01 v1 (block0 rows of t)
        t0 = m0 * t * dinv0
        s = m1 * ell.spmv(data, t0)            # A10 d0^{-1} A01 v1
        return s0 * (s - m1 * t) + 2.0 * bc1 * v   # -A11 v1, bc sign fix

    dS = s0 * schur_diag(ell, data, m0, dinv0, torch.zeros_like(bc1)) \
        + 2.0 * bc1
    return Sv, dS, dinv0


def make_schur_pc(ell, data, m0, bc1, *, cheb_steps: int = 4,
                  power_iters: int = 10, lmin_ratio: float = 30.0
                  ) -> Callable:
    """Build P^{-1} for MINRES from an assembled ELL Jacobian.

    m0:  (N,) 1.0 on block0 components (the invertible-diagonal block).
    bc1: (N,) 1.0 on Dirichlet dofs inside block1 (their rows are
         identity in A, which makes the raw S~ act as -I there; the
         +2 bc correction in S~ and its diagonal restores +I).
    Returns Minv(r) applying blockdiag(|d0|^{-1}, Chebyshev(S~))."""
    m1 = 1.0 - m0
    Sv, dS, dinv0 = schur_operator(ell, data, m0, bc1)
    dS_safe = torch.where(torch.abs(dS) > 1e-300, dS, 1.0)
    dinvS = m1 / dS_safe
    # 1.15 safety on the power estimate: ~10 iterations underestimate
    # lmax when the top eigenvalues cluster, and a Chebyshev polynomial
    # evaluated past its interval loses positivity (breaks MINRES)
    lmax = 1.15 * _power_lmax(Sv, dinvS, m1, power_iters)
    lmin = lmax / lmin_ratio
    cheb = partial(cheb_solve, Sv, dinvS, lmin, lmax, steps=cheb_steps)
    adinv0 = m0 * torch.abs(dinv0)

    def Minv(r):
        return adinv0 * r + cheb(m1 * r)

    return Minv


def make_schur_mg_pc(ell, data, m0, bc1, perm, grid_shape, free_grid,
                     levels: int, nu: int = 2) -> Callable:
    """Block-Schur preconditioner with a geometric-multigrid S-solve for
    LATTICE-structured block1 fields (P2 on uniform triangulations, Q_p on
    uniform quad grids: their dofs form a complete (pN+1)^2 lattice,
    la/gmg.py lattice_map).

    The Schur complement of the LVPP saddle systems is stiffness-dominated
    (S ~ alpha K + coupling); one V-cycle on the spectrally equivalent
    lattice operator alpha A5 + m2d(x) is h- and alpha-robust where a
    Chebyshev polynomial's MINRES counts grow with alpha/h^2.

    The stencil coefficients come from the operator itself, matrix-free:
    the masked mean of the diagonal's excess over the row sums, over 4,
    is the constant Laplacian strength (a per-node fit would bake the P2
    vertex/edge diagonal checkerboard into the coefficient, and the
    V-cycle stops converging); the pointwise remainder stays in the
    diagonal m2d term.

    perm: (prod(grid_shape),) device tensor, the global dof index of each
    lattice point; free_grid: bool device tensor of grid_shape."""
    from .gmg import build_hierarchy_var, v_cycle_var
    m1 = 1.0 - m0
    Sv, dS, dinv0 = schur_operator(ell, data, m0, bc1)
    dtype = data.dtype
    free_flat = free_grid.reshape(-1).to(dtype)
    rowsum = Sv(m1)                          # S * ones on block1
    dS_l = dS[perm]
    excess = (dS_l - torch.clamp(rowsum[perm], min=0.0)) * free_flat
    alpha_c = torch.clamp(torch.sum(excess)
                          / (4.0 * torch.clamp(torch.sum(free_flat),
                                               min=1.0)),
                          min=1e-30)
    m2d_g = torch.clamp(dS_l - 4.0 * alpha_c, min=0.0).reshape(grid_shape)
    alpha_g = alpha_c.expand(grid_shape)
    hierarchy = build_hierarchy_var(alpha_g, m2d_g, free_grid, levels)
    adinv0 = m0 * torch.abs(dinv0)

    def Minv(r):
        rg = (m1 * r)[perm].reshape(grid_shape)
        zg = v_cycle_var(rg, hierarchy, nu=nu)
        # perm is a permutation: a deterministic copy, never a sum
        z = torch.zeros_like(r).index_copy_(0, perm, zg.reshape(-1))
        return adinv0 * r + m1 * z

    return Minv
