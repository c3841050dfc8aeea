"""Geometric multigrid V-cycle preconditioner for lattice operators
alpha*K5 + diag(w) on an m x m vertex-centered dof lattice, and the
preconditioned CG that drives it.

The P1 obstacle fast path (models/obstacle_p1.py) reduces every Newton
step to an SPD Schur system S = alpha*K + diag(m2d) with pinned
(active/boundary) rows — on rectangle_mesh the stiffness K is exactly
the constant 5-point stencil {4; -1 N/S/E/W}, so only the diagonal
varies between levels and Newton steps. A V(1,1) cycle with damped-Jacobi
smoothing, full-weighting restriction and bilinear prolongation
(R = P^T/4, symmetric — CG-safe) bounds the PCG iteration count where
Jacobi-CG needs O(1/h) iterations.

Pinned rows are folded into the diagonal (w += PIN at non-free dofs):
the smoother then freezes them and coarse corrections vanish there.
Coarse diagonals follow the mass-like scaling w_{l+1} = 4 * FW(w_l).

Plain PyTorch in f32. This module is the preconditioner of the all-f64
`pc="mg"` branch and the oracle the fused MG-PCG kernel
(ops/mgfused.py) is tested against.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..core.logging import count

# diagonal weight standing in for a pinned (identity) row; large enough
# that the coarse-grid correction and smoother leave those dofs alone,
# small enough that f32 products with O(1e14) Schur diagonals stay finite
PIN = 1e18

_R_CACHE = {}


def _restriction_matrix(m: int, dtype) -> np.ndarray:
    """1-D full-weighting restriction matrix R (M+1, m), rows
    [1, 2, 1]/4 centered at the even fine points. 2-D restriction is the
    Kronecker form R X R^T; prolongation its exact transpose 4 R^T E R."""
    key = (m, np.dtype(dtype).name)
    if key not in _R_CACHE:
        M = (m - 1) // 2 + 1
        R = np.zeros((M, m), np.dtype(dtype))
        c = 2 * np.arange(M)
        R[np.arange(M), c] = 0.5
        R[np.arange(M - 1), c[:-1] + 1] += 0.25
        R[np.arange(1, M), c[1:] - 1] += 0.25
        _R_CACHE[key] = R
    return _R_CACHE[key]


_RT_CACHE = {}


def _r_tensor(m: int, like: torch.Tensor) -> torch.Tensor:
    # Transfers must be exact f32: a TF32 product keeps ~3 decimal digits,
    # which makes the preconditioner unsymmetric and breaks CG. Both
    # switches are set off explicitly before every transfer.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    key = (m, like.dtype, like.device)
    if key not in _RT_CACHE:
        np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
        _RT_CACHE[key] = torch.as_tensor(_restriction_matrix(m, np_dtype),
                                         device=like.device)
    return _RT_CACHE[key]


def restrict(r2d: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction (m=2M+1 -> M+1), vertex-centered:
    R X R^T as two full-precision matmuls."""
    R = _r_tensor(r2d.shape[0], r2d)
    return R @ r2d @ R.T


def prolong(e2d: torch.Tensor) -> torch.Tensor:
    """Bilinear prolongation (M+1 -> 2M+1), the exact transpose of
    4*restrict."""
    m = 2 * (e2d.shape[0] - 1) + 1
    R = _r_tensor(m, e2d)
    return 4.0 * (R.T @ e2d @ R)


def k5_apply(v2d: torch.Tensor) -> torch.Tensor:
    """Constant 5-point stiffness {4; -1 N/S/E/W} with zero Dirichlet
    exterior (P1 stiffness on a uniform right-triangulated lattice; the
    diagonal couplings are exactly zero, cf. the assembled DIA stencil)."""
    vp = torch.nn.functional.pad(v2d, (1, 1, 1, 1))
    return (4.0 * v2d - vp[:-2, 1:-1] - vp[2:, 1:-1]
            - vp[1:-1, :-2] - vp[1:-1, 2:])


def _levels_for(m: int) -> List[int]:
    ms = [m]
    while ms[-1] >= 9 and (ms[-1] - 1) % 2 == 0:
        ms.append((ms[-1] - 1) // 2 + 1)
    return ms


def w_hierarchy(w_fine2d: torch.Tensor, nlev: int) -> List[torch.Tensor]:
    """Per-level diagonals w_0 = w_fine, w_{l+1} = 4 * FW(w_l)."""
    ws = [w_fine2d]
    for _ in range(1, nlev):
        ws.append(4.0 * restrict(ws[-1]))
    return ws


def vcycle(ws: List[torch.Tensor], alpha, b: torch.Tensor,
           nu: int = 1, omega: float = 0.8,
           coarse_sweeps: int = 24) -> torch.Tensor:
    """One V(nu,nu) cycle for (alpha*K5 + diag(ws[0])) x = b on 2-D
    grids; the coarsest level is smoothed `coarse_sweeps` times."""
    nlev = len(ws)
    diags = [alpha * 4.0 + w for w in ws]

    def smooth(l, x, b, sweeps):
        d = diags[l]
        for _ in range(sweeps):
            r = b - (alpha * k5_apply(x) + ws[l] * x)
            x = x + omega * r / d
        return x

    def vc(l, b):
        if l == nlev - 1:
            return smooth(l, torch.zeros_like(b), b, coarse_sweeps)
        x = smooth(l, torch.zeros_like(b), b, nu)
        r = b - (alpha * k5_apply(x) + ws[l] * x)
        e = vc(l + 1, restrict(r))
        x = x + prolong(e)
        return smooth(l, x, b, nu)

    return vc(0, b)


def make_mg_pc(m: int, nu: int = 1, omega: float = 0.8,
               coarse_sweeps: int = 24, dtype=torch.float32):
    """Returns setup(alpha, w) -> pc(r) ~ (alpha*K5 + diag(w))^{-1} r.

    alpha: scalar (0-d tensor or float). w: (m*m,) nonnegative diagonal
    (PIN at pinned rows). r: (m*m,) residual. One V(nu,nu) cycle."""
    ms = _levels_for(m)

    def setup(alpha, w_fine):
        """Build the level hierarchy once per operator (per Newton
        direction); the returned pc(r) is then called per CG iteration."""
        alpha = torch.as_tensor(alpha, dtype=dtype, device=w_fine.device)
        ws = w_hierarchy(w_fine.reshape(m, m).to(dtype), len(ms))

        def pc(r_fine):
            r2 = r_fine.reshape(m, m).to(dtype)
            return vcycle(ws, alpha, r2, nu, omega,
                          coarse_sweeps).reshape(-1)

        return pc

    return setup


def pcg(matvec: Callable, b: torch.Tensor, precond: Callable, tol,
        maxiter: int, stall_window: int = 16, stall_guard: float = 1e4,
        chunk: int = 16):
    """Preconditioned CG with best-iterate tracking, breakdown guards and
    the noise-floor stall exit (exit once the best residual is within
    stall_guard of the stop threshold and has not improved for
    stall_window iterations). Returns (best x, iterations as a 0-d
    int64 tensor).

    The loop's condition is read on the host once per `chunk` iterations;
    inside a chunk each iteration is masked by the device-side condition,
    and a dead iteration is the identity, so the result and the count are
    those of the unchunked loop."""
    tiny = torch.finfo(b.dtype).tiny
    dev = b.device
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    bnorm2 = torch.dot(b, b)
    stop = tol * tol * bnorm2
    guard_stop = stall_guard * stop
    i = torch.zeros((), dtype=torch.int64, device=dev)
    ib = torch.zeros((), dtype=torch.int64, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    xb = x
    rr = bnorm2
    rrb = bnorm2

    def live_of(i, ok, rr, rrb, ib):
        stalled = (i - ib > stall_window) & (rrb < guard_stop)
        return ok & ~stalled & (i < maxiter) & (rr > stop)

    while True:
        count("host_reads")
        if not bool(live_of(i, ok, rr, rrb, ib)):
            return xb, i
        for _ in range(chunk):
            live = live_of(i, ok, rr, rrb, ib)
            Ap = matvec(p)
            pAp = torch.dot(p, Ap)
            good = live & (pAp > tiny) & (rz > tiny)
            a = torch.where(good, rz / torch.where(good, pAp, 1.0), 0.0)
            x = torch.where(live, x + a * p, x)
            r = torch.where(live, r - a * Ap, r)
            z = precond(r)
            rz_new = torch.where(live, torch.dot(r, z), rz)
            beta = torch.where(good, rz_new / torch.where(good, rz, 1.0),
                               0.0)
            p = torch.where(live, z + beta * p, p)
            rr = torch.where(live, torch.dot(r, r), rr)
            better = live & (rr < rrb)
            xb = torch.where(better, x, xb)
            rrb = torch.where(better, rr, rrb)
            ib = torch.where(better, i + 1, ib)
            ok = torch.where(live, good, ok)
            i = torch.where(live, i + 1, i)
            rz = rz_new
