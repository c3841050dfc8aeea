"""Halo-exchange distribution of the FD obstacle solver: the counterpart of
the reference package's parallel/halo.py.

The (N, N) grid's rows are split into nd strips along the shard axis of a
`ShardComm`; before each stencil application every strip is padded with
one halo row per neighbour, exchanged by `ring(+1)` / `ring(-1)` (the
reference's ppermute rings, its Vec.ghostUpdate(INSERT/FORWARD)), and the
global reductions inside CG are `psum`s, where the reference calls
comm.allreduce. The strips run batched: an (nloc, rows/nd, N) tensor.
The Newton loop reads the host once per Newton step, the CG loop once
per chunk of iterations (la/loop.while_loop), so the counts are those of
the reference's device while-loops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..la.loop import while_loop
from ..models.obstacle import spherical_cap_obstacle
from .comm import ShardComm


def _exchange_halo(block, comm: ShardComm):
    """Fill the first/last (halo) rows of each strip with the neighbours'
    boundary rows; the outermost strips keep theirs. block:
    (nloc, rows_local + 2, N)."""
    idx = comm.axis_index()[:, None]
    # the last interior row goes down to i + 1, the first up to i - 1
    down = comm.ring(block[:, -2], -1)
    up = comm.ring(block[:, 1], 1)
    first = torch.where(idx == 0, block[:, 0], down)
    last = torch.where(idx == comm.nd - 1, block[:, -1], up)
    return torch.cat([first[:, None], block[:, 1:-1], last[:, None]], dim=1)


def _lap_local(block, h2inv, interior):
    """5-point Laplacian on the halo-padded strips; identity on Dirichlet
    rows/cols (interior mask is halo-padded too)."""
    u = block
    z_row = torch.zeros_like(u[:, :1])
    z_col = torch.zeros_like(u[:, :, :1])
    lap = 4.0 * u
    lap = lap - torch.cat([u[:, 1:], z_row], dim=1)
    lap = lap - torch.cat([z_row, u[:, :-1]], dim=1)
    lap = lap - torch.cat([u[:, :, 1:], z_col], dim=2)
    lap = lap - torch.cat([z_col, u[:, :, :-1]], dim=2)
    return torch.where(interior, lap * h2inv, u)


def fd_obstacle_solve_sharded(
    N: int,
    comm: Optional[ShardComm] = None,
    max_outer: int = 100,
    newton_tol: float = 1e-4,
    newton_max: int = 50,
    outer_tol: float = 1e-9,
    alpha_cap: float = 1e2,
    cg_tol: float = 1e-10,
    verbose: bool = False,
    *,
    n_devices: int = 8,
    device="cuda",
    counts: Optional[dict] = None,
):
    """Distributed models/obstacle_fd.fd_obstacle_solve: the (N, N) grid
    row-split into comm.nd strips (default: n_devices strips in this
    process on `device`) with halo exchange; N rows are padded to a
    multiple of the strip count. Returns (u, phi, outer iterations,
    Newton total) as the reference does; `counts`, a dict, receives the
    per-outer Newton counts and the CG total."""
    comm = comm or ShardComm(n_devices, device)
    nd, dev = comm.nd, comm.device
    f64 = torch.float64
    rows = int(np.ceil(N / nd)) * nd      # padded row count
    pad = rows - N
    rl = rows // nd

    xs = np.linspace(-1.0, 1.0, N)
    h2inv = 1.0 / (xs[1] - xs[0]) ** 2
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    phi_full = spherical_cap_obstacle(
        np.stack([X.ravel(), Y.ravel()])).reshape(N, N)
    interior_full = np.zeros((N, N), bool)
    interior_full[1:-1, 1:-1] = True

    def strips(a, fill, dtype=f64):
        a = np.pad(a, ((0, pad), (0, 0)), constant_values=fill)
        a = a.reshape(nd, rl, N)[comm.local]
        return torch.as_tensor(a, dtype=dtype, device=dev)

    phi = strips(phi_full, -1e3)
    interior = strips(interior_full, False, torch.bool)
    z = torch.zeros_like(interior[:, :1])
    int_pad = torch.cat([z, interior, z], dim=1)

    def halo_pad(a):
        zr = torch.zeros_like(a[:, :1])
        return _exchange_halo(torch.cat([zr, a, zr], dim=1), comm)

    def lap(a):
        return _lap_local(halo_pad(a), h2inv, int_pad)[:, 1:-1]

    def dot(a, b):
        return comm.psum((a * b).sum((1, 2)))

    cg_total = torch.zeros((), dtype=torch.int64, device=dev)

    def cg(matvec, b, maxiter):
        x = torch.zeros_like(b)
        rs = dot(b, b)
        stop = cg_tol * cg_tol * rs

        def cond(s):
            i, x, r, p, rs = s
            return (i < maxiter) & (rs > stop)

        def body(s):
            i, x, r, p, rs = s
            Ap = matvec(p)
            a_ = rs / dot(p, Ap)
            x = x + a_ * p
            r = r - a_ * Ap
            rs2 = dot(r, r)
            p = r + (rs2 / rs) * p
            return i + 1, x, r, p, rs2

        i0 = torch.zeros((), dtype=torch.int64, device=dev)
        i, x, _, _, _ = while_loop(cond, body, (i0, x, b, b, rs))
        return x, i

    def newton(u, psi, psi_k, alpha):
        nonlocal cg_total

        def residual(u, psi):
            g_u = torch.where(interior, alpha * lap(u) + (psi - psi_k), u)
            # overflow-safe exp (see models/obstacle_fd.py residual)
            g_p = torch.where(interior, u - torch.exp(torch.clamp(
                psi, max=500.0)) - phi, 0.0)
            return g_u, g_p

        def body(state):
            nonlocal cg_total
            it, u, psi, _ = state
            g_u, g_p = residual(u, psi)
            d = torch.exp(torch.clamp(psi, max=500.0))
            row_scale = alpha * 4.0 * h2inv + 1.0
            active = interior & (d * 1e14 * row_scale < 1.0)
            free = interior & ~active
            dsafe = torch.clamp(d, min=1e-300)
            du_a = torch.where(active, -g_p - d * g_u, 0.0)
            rhs = torch.where(free, -g_u - g_p / dsafe - alpha * lap(du_a),
                              0.0)
            # symmetric Jacobi scaling (see models/obstacle_fd.py)
            sD = torch.where(free, torch.sqrt(alpha * 4.0 * h2inv
                                              + 1.0 / dsafe), 1.0)

            def S(v):
                vf = torch.where(free, v / sD, 0.0)
                return torch.where(free, (alpha * lap(vf) + vf / dsafe) / sD,
                                   v)

            y, its = cg(S, torch.where(free, rhs / sD, 0.0), 20 * N)
            cg_total = cg_total + its
            du = torch.where(free, y / sD, du_a)
            dpsi = torch.where(interior, -(g_u + alpha * lap(du)), 0.0)
            u, psi = u + du, psi + dpsi
            g_u, g_p = residual(u, psi)
            return it + 1, u, psi, torch.sqrt(dot(g_u, g_u) + dot(g_p, g_p))

        g_u0, g_p0 = residual(u, psi)
        n0 = torch.sqrt(dot(g_u0, g_u0) + dot(g_p0, g_p0))
        it0 = torch.zeros((), dtype=torch.int64, device=dev)
        it, u, psi, _ = while_loop(
            lambda s: (s[0] < newton_max) & (s[3] > newton_tol * n0),
            body, (it0, u, psi, n0), chunk=1)
        return u, psi, int(it)

    shape = (comm.nloc, rl, N)
    u = torch.zeros(shape, dtype=f64, device=dev)
    psi = torch.ones(shape, dtype=f64, device=dev)
    psi_k = torch.zeros(shape, dtype=f64, device=dev)

    alpha = 1.0
    total = 0
    per_outer = []
    u_prev = u
    k_done = 0
    for k in range(max_outer):
        try:
            alpha = min(max(1.5 ** (1.5**k) - alpha, 1.0), alpha_cap)
        except OverflowError:
            alpha = alpha_cap
        u, psi, nits = newton(u, psi, psi_k,
                              torch.tensor(alpha, dtype=f64, device=dev))
        total += nits
        per_outer.append(nits)
        psi_k = psi
        inc = float(torch.sqrt(dot(u - u_prev, u - u_prev)))
        k_done = k + 1
        if verbose:
            print(f"outer {k + 1} alpha={alpha:.3g} newton={nits} "
                  f"inc={inc:.2e}", flush=True)
        if inc < outer_tol:
            break
        u_prev = u

    if counts is not None:
        counts.update(newton_per_outer=per_outer, cg_its=int(cg_total))
    u_all = comm.gather_shards(u).reshape(rows, N)[:N]
    return u_all.cpu().numpy(), phi_full, k_done, total
