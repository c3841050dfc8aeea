"""Device-resident block-tridiagonal LDL (block-Thomas) direct solver.

The sparse-direct replacement for MUMPS on *lattice-structured* problems —
every reference full-protocol example (gradient constraint 200^2,
eigenvalue 100^2, thermoforming 150^2, multiphase 50^2; the reference
solves each Newton system with `pc_factor_mat_solver_type: mumps`, e.g.
examples/01_obstacle_problem/obstacle_pg.py:131) — and, through BFS
level sets of the dof graph, on unstructured meshes too.

Idea: order dofs by mesh lines (quantized coordinate levels). FEM coupling
only reaches `span` lines, so grouping `span` lines per block makes the
(equilibrated) Jacobian block-TRIDIAGONAL with dense (bs, bs) blocks:

    A = [[D0, U0          ],
         [L0, D1, U1      ],
         [    L1, D2, ... ]]

Block-Thomas factorization/solve is then a sequence of dense (bs, bs)
matmuls and inverses (`torch.linalg.inv`, `@`) on the solve device;
cyclic reduction (`bt_factor_cr`) batches each of its log2(nb) levels.

Numerics: the LVPP saddle Jacobians are symmetric quasi-definite after
Jacobi equilibration (latent block negative definite, primal block positive
definite), for which unpivoted block LDL^T is strongly factorizable
(Vanderbei); each block inverse still uses partially-pivoted LU inside
`torch.linalg.inv` (or, with `pc_factor_blockinv='schur'` and an f64
factor, recursive block elimination: `_block_inv`). The factor runs in
f32 (default) or f64 (`pc_factor_dtype`) and reaches f64 direction
accuracy through iterative refinement against the assembled ELL
operator, driven by the Newton solver (solve/newton.py
`_bt_direction`, solve/nonlinear.py `fused_newton_btlu`).

Every block product runs with TF32 off (`_exact_matmul`): a low-precision
block product, compounded through the nb nested Schur steps, leaves a
factor whose refinement diverges.

The host side (`LineBlocking` and its maps) is numpy, as in the reference;
the device maps are int64 tensors moved to the solve device once.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.logging import count, span
from ..ops.btapply import bt_apply
from .loop import while_loop

BLOCKINV_SCHEMES = ("ns", "schur")


def _block_inv(M: torch.Tensor, algo: str = "ns") -> torch.Tensor:
    """Dense (batched) block inverse in the factor dtype.

    'ns' (default): LU with partial pivoting (`inv_ex`: no host read of a
    singularity check a block; a singular block gives non-finite entries,
    as the reference's inverse does). The reference's 'ns' is an f32
    inverse refined by Newton-Schulz, a workaround for a device without
    an f64 LU; the H100 has one, so 'ns' is the plain f64 inverse.

    'schur' (f64 factors): recursive unpivoted 2x2 block elimination
    (`_block_inv_schur`). At deep contact the equilibrated obstacle
    saddle blocks carry off-diagonal u-psi entries ~1e8 (cond ~1e16): a
    pivoted LU of the whole block mixes the two scales in its row swaps,
    the block elimination keeps them apart (the blocks and their nested
    Schur complements are symmetric quasi-definite, so unpivoted block
    elimination is stable, Vanderbei) and equilibrates each leaf."""
    if algo == "schur" and M.dtype == torch.float64:
        return _block_inv_schur(M)
    return torch.linalg.inv_ex(M)[0]


def _block_inv_schur(M: torch.Tensor, leaf: int = 128) -> torch.Tensor:
    """inv(M) by recursive 2x2 block elimination (see _block_inv
    'schur'), with leading batch axes. Leaf blocks are scaled to unit row
    max-norm symmetrically, T M T with T = diag(1/sqrt(rownorm)), and
    inverted by LU: inv(M) = T inv(TMT) T."""
    n = M.shape[-1]
    if n <= leaf:
        t = 1.0 / torch.sqrt(torch.clamp(M.abs().amax(dim=-1), min=1e-300))
        Xs = torch.linalg.inv_ex(t[..., :, None] * M * t[..., None, :])[0]
        return t[..., :, None] * Xs * t[..., None, :]
    k = n // 2
    A = M[..., :k, :k]
    B = M[..., :k, k:]
    C = M[..., k:, :k]
    D = M[..., k:, k:]
    Ai = _block_inv_schur(A, leaf)
    CAi = C @ Ai
    Si = _block_inv_schur(D - CAi @ B, leaf)
    AiB = Ai @ B
    top = torch.cat([Ai + AiB @ (Si @ CAi), -AiB @ Si], dim=-1)
    bot = torch.cat([-Si @ CAi, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _check_blockinv(blockinv: str):
    """Validate `pc_factor_blockinv` as the reference does."""
    if blockinv not in BLOCKINV_SCHEMES:
        raise ValueError(f"pc_factor_blockinv must be one of "
                         f"{BLOCKINV_SCHEMES}, got {blockinv!r}")


@contextlib.contextmanager
def _exact_matmul():
    """TF32 off for the f32 block products inside, restored on exit."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _dtype(name: str) -> torch.dtype:
    return torch.float32 if name == "f32" else torch.float64


def factor_dtype(option) -> str:
    """The factor dtype named by `pc_factor_dtype` (default f32): 'f64'
    for 'f64' or 'double', else 'f32'."""
    return "f64" if str(option) in ("f64", "double") else "f32"


def _check_apply_dtype(dtype: str, apply_dtype: Optional[str]):
    """Reject the unsupported f32-factor / f64-apply request loudly:
    apply_dtype only ever CASTS A FACTOR DOWN for cheap applies — an f32
    factor carries no f64 accuracy to recover."""
    if apply_dtype in ("f64", "double") and dtype not in ("f64", "double"):
        raise ValueError("pc_factor_apply_dtype='f64' requires "
                         "pc_factor_dtype='f64' (an f32 factor cannot be "
                         "applied at f64 accuracy)")


def _line_ids(points: np.ndarray, axis: int) -> np.ndarray:
    """Rank of each dof's quantized coordinate level along `axis`."""
    c = points[:, axis]
    span = max(float(c.max() - c.min()), 1.0)
    q = np.round(c / (1e-9 * span)).astype(np.int64)
    levels = np.unique(q)
    return np.searchsorted(levels, q)


def _graph_level_blocks(pattern) -> Optional[np.ndarray]:
    """BFS level-set blocking of the dof GRAPH — the unstructured-mesh
    generalization of coordinate lines.

    Property used: an (undirected) graph edge connects nodes whose BFS
    levels differ by AT MOST one, so ordering dofs by BFS level makes
    the matrix exactly block-tridiagonal with one level per block, at
    bs = max level width. The root is chosen pseudo-peripherally
    (repeated farthest-node BFS) to minimize the max width. Returns the
    (N,) block id per dof, or None when the graph degenerates (fewer
    than 3 levels)."""
    import scipy.sparse as sp
    N, K = pattern.ell_cols.shape
    rows = np.repeat(np.arange(N, dtype=np.int64), K)
    cols = pattern.ell_cols.astype(np.int64).reshape(-1)
    ones = np.ones(len(cols), np.int8)
    A = sp.coo_matrix((ones, (rows, cols)), shape=(N, N)).tocsr()
    A = (A + A.T).tocsr()
    lev = bfs_level_sets(A)
    if lev is None or int(lev.max()) + 1 < 3:
        return None
    return lev


def bfs_level_sets(A) -> Optional[np.ndarray]:
    """Pseudo-peripheral BFS levels of a symmetric CSR adjacency ->
    (N,) level id per node; unreached (isolated) nodes get level 0."""
    N = A.shape[0]

    def bfs(start):
        lev = np.full(N, -1, np.int64)
        lev[start] = 0
        frontier = np.asarray([start], np.int64)
        d = 0
        while frontier.size:
            d += 1
            nbrs = np.unique(A[frontier].indices)
            frontier = nbrs[lev[nbrs] < 0]
            lev[frontier] = d
        return lev

    # start from a max-degree node: node 0 can be isolated, and a BFS
    # started there never leaves it
    deg = np.diff(A.indptr)
    lev = bfs(int(np.argmax(deg)))
    best = None
    for _ in range(3):   # pseudo-peripheral iterations
        reached = lev >= 0
        start = int(np.argmax(np.where(reached, lev, -1)))
        lev = bfs(start)
        w = np.bincount(lev[lev >= 0])
        key = (int(w.max()), -int(lev.max()))
        if best is None or key < best[0]:
            best = (key, lev.copy())
    lev = best[1]
    # unreached dofs (disconnected: pure-diagonal rows) couple to nothing
    # — any block is valid; level 0 keeps the count balanced least-worst
    lev[lev < 0] = 0
    return lev


@dataclass(frozen=True)
class LineBlocking:
    """Host-precomputed block-tridiagonal structure for one ELL pattern.

    nb, bs:    number of blocks / padded block size
    rhs_idx:   (N,) position of dof r in the flat (nb*bs,) block vector
    tgt_d/l/u: (N*K,) flat scatter target of each ELL slot into the dense
               D (nb,bs,bs) / L,U (nb-1,bs,bs) tensors; the one drop
               position past the end (nb*bs*bs for D, (nb-1)*bs*bs for
               L and U) for slots that belong to another tensor
    pad_idx:   flat D-diagonal positions of padding dofs (get 1.0)
    """

    nb: int
    bs: int
    rhs_idx: np.ndarray
    tgt_d: np.ndarray
    tgt_l: np.ndarray
    tgt_u: np.ndarray
    pad_idx: np.ndarray
    dense_ok: bool = True
    max_bytes: float = 11e9

    def fits_dense(self, itemsize: int = 4, algo: str = "thomas") -> bool:
        """Device-memory fit of the dense factor path at the ACTUAL factor
        itemsize. Thomas keeps ~5 (nb,bs,bs) tensors live (D,L,U +
        Minv,T); cyclic reduction peaks much higher (padded inputs and
        the level stacks), hence its 16x multiplier. max_bytes keeps the
        reference's 11e9, so the dense/streamed choice is the
        reference's."""
        mult = 16.0 if algo == "cr" else 5.0
        return mult * self.nb * self.bs * self.bs * itemsize \
            <= self.max_bytes

    def fits_streamed(self, itemsize: int = 4) -> bool:
        """Streamed live set: the Minv stack + ~6 (bs,bs) transients."""
        return (self.nb + 6.0) * self.bs * self.bs * itemsize \
            <= self.max_bytes

    @classmethod
    def build(cls, pattern, points: np.ndarray,
              max_bytes: float = 11e9) -> "LineBlocking":
        """pattern: la/ell.EllPattern; points: (N, gdim) dof coordinates.

        Chooses the coordinate axis that minimizes the padded block size,
        groups `span` lines per block (span = max coupling distance in
        lines), and precomputes the ELL-slot -> dense-block scatter maps.
        Raises ValueError when the dof graph is not line-structured
        enough. When the DENSE factor tensors exceed max_bytes but the
        STREAMED variant (bt_factor_streamed) fits, a LineBlocking with
        dense_ok=False is returned instead of raising."""
        N, K = pattern.ell_cols.shape
        ell_cols = pattern.ell_cols.astype(np.int64)
        rows = np.repeat(np.arange(N, dtype=np.int64), K)
        cols = ell_cols.reshape(-1)

        best = None
        for axis in range(points.shape[1]):
            line = _line_ids(points, axis)
            span = int(np.abs(line[rows] - line[cols]).max())
            if span == 0:
                continue
            g = span
            blk = line // g
            nb = int(blk.max()) + 1
            if nb < 3:
                continue
            bs = int(np.bincount(blk, minlength=nb).max())
            if best is None or bs < best[0]:
                best = (bs, nb, blk, span)
        # Unstructured candidate: BFS level sets of the dof graph,
        # considered whenever coordinate lines fail OR pad poorly
        # (boundary-snapped points fragment the coordinate levels).
        # Selection by dense-factor footprint nb*bs^2, which also orders
        # factor FLOPs (nb*bs^3 at fixed N) and keeps true lattices on
        # their coordinate lines.
        if best is None or best[0] * best[1] > 1.25 * N:
            lev = _graph_level_blocks(pattern)
            if lev is not None:
                nb_g = int(lev.max()) + 1
                bs_g = int(np.bincount(lev, minlength=nb_g).max())
                if nb_g >= 3 and (best is None or nb_g * bs_g * bs_g
                                  < best[1] * best[0] * best[0]):
                    best = (bs_g, nb_g, lev, 1)
        if best is None:
            raise ValueError("dof graph is not line-structured")
        bs, nb, blk, span = best
        dense_ok = 5.0 * nb * bs * bs * 4 <= max_bytes
        # streamed live set: the Minv stack + ~6 (bs,bs) transients
        if not dense_ok and (nb + 6.0) * bs * bs * 4 > max_bytes:
            raise ValueError(
                f"block-tridiagonal factors too large even streamed: "
                f"nb={nb} bs={bs} "
                f"(~{(nb + 6) * bs * bs * 4 / 1e9:.1f} GB)")

        # position of each dof inside its block (stable order within block)
        order = np.lexsort((np.arange(N), blk))
        loc = np.empty(N, dtype=np.int64)
        loc[order] = np.arange(N) - np.concatenate(
            [[0], np.cumsum(np.bincount(blk, minlength=nb))])[blk[order]]
        rhs_idx = blk * bs + loc

        br, bc = blk[rows], blk[cols]
        i, j = loc[rows], loc[cols]
        drop_d = nb * bs * bs
        drop_lu = (nb - 1) * bs * bs
        tgt_d = np.where(br == bc, br * bs * bs + i * bs + j, drop_d)
        # L[k] = A[block k+1, block k]; U[k] = A[block k, block k+1]
        tgt_l = np.where(br == bc + 1, bc * bs * bs + i * bs + j, drop_lu)
        tgt_u = np.where(bc == br + 1, br * bs * bs + i * bs + j, drop_lu)
        # ELL PADDING slots carry the row's diagonal column (la/ell.py pads
        # ell_gather with slot nnz): they scatter to the DROP position, not
        # onto the true diagonal — bt_assemble scatter-SETs, and a 0-valued
        # padding write could otherwise clobber the diagonal entry
        pad_slots = pattern.ell_gather.reshape(-1) >= pattern.nnz
        tgt_d[pad_slots] = drop_d
        tgt_l[pad_slots] = drop_lu
        tgt_u[pad_slots] = drop_lu
        beyond = np.abs(br - bc) > 1
        if beyond.any():
            raise ValueError("coupling beyond adjacent blocks")

        counts = np.bincount(blk, minlength=nb)
        pad = []
        for k in range(nb):
            pad.extend(k * bs * bs + p * bs + p
                       for p in range(counts[k], bs))
        return cls(nb=nb, bs=bs, rhs_idx=rhs_idx.astype(np.int32),
                   tgt_d=tgt_d.astype(np.int32),
                   tgt_l=tgt_l.astype(np.int32),
                   tgt_u=tgt_u.astype(np.int32),
                   pad_idx=np.asarray(pad, dtype=np.int32),
                   dense_ok=bool(dense_ok),
                   max_bytes=float(max_bytes))

    def _cached(self, name: str, device, make):
        cache = self.__dict__.setdefault("_device_cache", {})
        key = (name, str(torch.device(device)))
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def device_maps(self, device) -> dict:
        """The index arrays as int64 tensors on `device` (moved once)."""
        def make():
            def t(a):
                return torch.as_tensor(a.astype(np.int64), device=device)
            return {"rhs_idx": t(self.rhs_idx), "tgt_d": t(self.tgt_d),
                    "tgt_l": t(self.tgt_l), "tgt_u": t(self.tgt_u),
                    "pad_idx": t(self.pad_idx)}
        return self._cached("dense", device, make)

    def streamed_maps(self, device) -> dict:
        """Per-block padded COO maps for the STREAMED factor/apply
        (bt_factor_streamed / bt_apply_streamed), as int64 tensors on
        `device` (moved once): instead of materializing dense (nb,bs,bs)
        D/L/U tensors, each step scatters only ITS block's ELL entries, so
        the live set is the Minv stack plus a few (bs,bs) transients.
        Padding convention: src = NK (gathers the appended zero of
        flat_p), i = bs (the dropped row), j = 0.

        Keys: d_src/d_tgt (nb, Pd) with d_tgt in [0, bs*bs]; pad (nb, bs)
        per-block diagonal fill positions; l_src/l_i/l_j and u_src/u_i/u_j
        (nb-1, P*)."""
        return self._cached("streamed", device,
                            lambda: self._streamed_maps_on(device))

    def _streamed_maps_on(self, device) -> dict:
        nb, bs = self.nb, self.bs
        bsq = bs * bs
        NK = len(self.tgt_d)

        def group(tgt_flat, nblocks, pad_loc):
            sel = np.flatnonzero(tgt_flat < nblocks * bsq)
            blk = tgt_flat[sel].astype(np.int64) // bsq
            loc = tgt_flat[sel].astype(np.int64) % bsq
            order = np.argsort(blk, kind="stable")
            blk, loc, src = blk[order], loc[order], sel[order]
            counts = np.bincount(blk, minlength=nblocks)
            P = max(int(counts.max()), 1)
            starts = np.concatenate([[0], np.cumsum(counts)])
            src_pad = np.full((nblocks, P), NK, np.int64)
            loc_pad = np.full((nblocks, P), pad_loc, np.int64)
            pos = np.arange(len(blk)) - starts[blk]
            src_pad[blk, pos] = src
            loc_pad[blk, pos] = loc
            return src_pad, loc_pad

        d_src, d_tgt = group(self.tgt_d.astype(np.int64), nb, bsq)
        l_src, l_tgt = group(self.tgt_l.astype(np.int64), nb - 1, bsq)
        u_src, u_tgt = group(self.tgt_u.astype(np.int64), nb - 1, bsq)
        # per-block diagonal fill of padding dofs: (nb, bs), drop slot bsq
        pad = np.full((nb, bs), bsq, np.int64)
        pidx = self.pad_idx.astype(np.int64)
        pblk, ploc = pidx // bsq, pidx % bsq
        for k in range(nb):
            lk = ploc[pblk == k]
            pad[k, :len(lk)] = lk
        sm = {"d_src": d_src, "d_tgt": d_tgt, "pad": pad,
              "l_src": l_src, "l_i": l_tgt // bs, "l_j": l_tgt % bs,
              "u_src": u_src, "u_i": u_tgt // bs, "u_j": u_tgt % bs}
        return {k: torch.as_tensor(v, device=device) for k, v in sm.items()}


def _equilibrate(ell_data, ell_cols):
    """(data_s, s): S A S with s = |diag|^-1/2, f64; s = 1 where the
    diagonal is zero to the f64 rounding of its row (|diag| <= eps
    max_j |A_ij|), as the reference leaves a zero diagonal unscaled.

    At deep contact the obstacle's latent rows carry diagonals
    exp(psi)-small (1e-75 on the disk at res 0.03, alpha 935) beside
    O(h^2) couplings: scaled by them, the couplings reach ~1e32, their
    squares in the block elimination swamp f64, and the factor breaks
    down (LVPP step 7 of example 01's disk). Left unscaled, such a row
    is a saddle row with a tiny diagonal, which the pivoted block
    inverses take."""
    row = torch.arange(ell_data.shape[0], device=ell_data.device)[:, None]
    diag = torch.sum(torch.where(ell_cols == row, ell_data,
                                 torch.zeros_like(ell_data)), dim=1)
    eps = torch.finfo(ell_data.dtype).eps
    live = torch.abs(diag) > eps * ell_data.abs().amax(dim=1)
    s = torch.where(live, 1.0 / torch.sqrt(torch.abs(diag)),
                    torch.ones_like(diag))
    return s[:, None] * ell_data * s[ell_cols], s


def _scatter_set(size: int, tgt, vals, dtype, device):
    """zeros(size) with out[tgt] = vals, tgt in [0, size]: position `size`
    is the drop slot (several writes may land there, in any order; it is
    cut off before the result is used)."""
    out = torch.zeros(size + 1, dtype=dtype, device=device)
    out.index_put_((tgt,), vals)
    return out[:size]


def bt_assemble(ell_data, ell_cols, maps, nb: int, bs: int,
                dtype: str = "f32"):
    """Equilibrate ELL data, cast to the factor dtype, scatter into dense
    (D, L, U) blocks.

    Returns (D, L, U, s) with s the f64 symmetric scale (|diag|^-1/2):
    the factored system is S A S, so directions are dx = s * solve(s * b).

    dtype: 'f32' (default; refinement recovers f64 accuracy) or 'f64' for
    systems whose equilibrated condition number exceeds ~1/eps_f32 — the
    multiphase softmax Jacobian saturates its psi block to ~eps0=1e-9 and
    the f32 factor stops being a contraction (refinement diverges)."""
    fdt = _dtype(dtype)
    dev = ell_data.device
    data_s, s = _equilibrate(ell_data, ell_cols)
    flat = data_s.to(fdt).reshape(-1)
    # scatter-SET, not add: each live ELL slot owns a distinct dense
    # position (ELL columns are unique per row)
    D = torch.zeros(nb * bs * bs + 1, dtype=fdt, device=dev)
    D.index_put_((maps["tgt_d"],), flat)
    D[maps["pad_idx"]] = 1.0
    L = _scatter_set((nb - 1) * bs * bs, maps["tgt_l"], flat, fdt, dev)
    U = _scatter_set((nb - 1) * bs * bs, maps["tgt_u"], flat, fdt, dev)
    return (D[:-1].reshape(nb, bs, bs), L.reshape(nb - 1, bs, bs),
            U.reshape(nb - 1, bs, bs), s)


def bt_factor(D, L, U, blockinv: str = "ns"):
    """Block-Thomas factorization: returns (Minv, T) with
    M_k = D_k - L_{k-1} Minv_{k-1} U_{k-1} (Schur recursion) and
    T_k = Minv_k U_k; nb dependent steps of one block inverse and two
    (bs, bs) products each. D (..., nb, bs, bs), L and U
    (..., nb - 1, bs, bs): leading axes are a batch of systems factored
    together (the Schwarz subdomains of parallel/dofpart.py)."""
    nb = D.shape[-3]
    Minv = torch.empty_like(D)
    T = torch.empty_like(U)
    with _exact_matmul():
        Minv[..., 0, :, :] = _block_inv(D[..., 0, :, :], blockinv)
        for k in range(1, nb):
            T[..., k - 1, :, :] = Minv[..., k - 1, :, :] @ U[..., k - 1, :, :]
            Minv[..., k, :, :] = _block_inv(
                D[..., k, :, :] - L[..., k - 1, :, :] @ T[..., k - 1, :, :],
                blockinv)
    return Minv, T


def _mv(A, v):
    """Block times vector: (bs, bs) @ (bs,), or a batch of each."""
    return A @ v if v.dim() == 1 else (A @ v.unsqueeze(-1)).squeeze(-1)


def bt_apply_reference(Minv, T, L, b_blocks):
    """Forward/back substitution for one flat rhs laid out as (nb, bs), or
    a batch (..., nb, bs) through factors with the same leading axes: the
    plain version of ops/btapply's kernel (bt_apply), which CPU tensors
    take."""
    nb = b_blocks.shape[-2]
    y = torch.empty_like(b_blocks)
    x = torch.empty_like(b_blocks)
    with _exact_matmul():
        y[..., 0, :] = b_blocks[..., 0, :]
        for k in range(1, nb):
            y[..., k, :] = b_blocks[..., k, :] - _mv(
                L[..., k - 1, :, :], _mv(Minv[..., k - 1, :, :],
                                         y[..., k - 1, :]))
        x[..., nb - 1, :] = _mv(Minv[..., nb - 1, :, :], y[..., nb - 1, :])
        for k in range(nb - 2, -1, -1):
            x[..., k, :] = (_mv(Minv[..., k, :, :], y[..., k, :])
                            - _mv(T[..., k, :, :], x[..., k + 1, :]))
    return x


def _rhs_blocks(s, b64, rhs_idx, nb, bs, fdt):
    bb = torch.zeros(nb * bs, dtype=fdt, device=b64.device)
    bb[rhs_idx] = (s * b64).to(fdt)
    return bb.reshape(nb, bs)


def bt_solve(Minv, T, L, s, b64, maps, nb: int, bs: int):
    """f64 rhs -> f64 direction through the factors (one refinement-free
    pass; the factor dtype is inferred from Minv)."""
    rhs_idx = maps["rhs_idx"]
    bb = _rhs_blocks(s, b64, rhs_idx, nb, bs, Minv.dtype)
    xb = bt_apply(Minv, T, L, bb).reshape(-1)
    return s * xb[rhs_idx].to(b64.dtype)


class BlockTriFactorization:
    """One assembled+factored system: solve(b64)->dx64, all on the device.

    apply_dtype='f32' with dtype='f64' is the production multiphase
    combination: the FACTOR recursion needs f64 (f32 Schur-complement
    error compounds through nb nested inversions until refinement
    diverges at the record's conditioning) but the APPLY does not — the
    f32-cast factors still contract refinement by orders of magnitude a
    pass."""

    def __init__(self, blocking: LineBlocking, ell, data64, arrays,
                 dtype: str = "f32", apply_dtype: Optional[str] = None,
                 blockinv: str = "ns"):
        _check_apply_dtype(dtype, apply_dtype)
        _check_blockinv(blockinv)
        maps = blocking.device_maps(data64.device)
        D, L, U, s = bt_assemble(data64, arrays["ell_cols"], maps,
                                 blocking.nb, blocking.bs, dtype)
        self.Minv, self.T = bt_factor(D, L, U, blockinv)
        self.L = L
        if (apply_dtype or dtype) == "f32" and dtype != "f32":
            self.Minv = self.Minv.to(torch.float32)
            self.T = self.T.to(torch.float32)
            self.L = self.L.to(torch.float32)
        self.s = s
        self._maps = maps
        self._nb, self._bs = blocking.nb, blocking.bs

    def solve(self, b):
        return bt_solve(self.Minv, self.T, self.L, self.s, b, self._maps,
                        self._nb, self._bs)


# ----------------------------------------- cyclic-reduction variant (CR)

def _cr_pad(D, L, U):
    """Pad a (nb, bs, bs) block-tridiagonal system to n = 2^m - 1 blocks
    with decoupled identity blocks (D=I, L=U=0) so every cyclic-reduction
    level halves exactly. Returns (D, L, U) padded."""
    nb, bs = D.shape[0], D.shape[1]
    m = int(np.ceil(np.log2(nb + 1)))
    n = 2 ** m - 1
    if n == nb:
        return D, L, U
    eye = torch.eye(bs, dtype=D.dtype, device=D.device).expand(
        n - nb, bs, bs)
    Z = torch.zeros((n - nb,) + tuple(L.shape[1:]), dtype=L.dtype,
                    device=L.device)
    return (torch.cat([D, eye]), torch.cat([L, Z]), torch.cat([U, Z]))


def bt_factor_cr(D, L, U, blockinv: str = "ns"):
    """Block CYCLIC REDUCTION factorization — the log-depth, batched
    alternative to the sequential block-Thomas recursion (bt_factor):
    ceil(log2 nb) levels of ONE batched inverse and six batched matmuls
    each, ~2.7x the FLOPs but 8x fewer dependent steps. Same unpivoted
    block-elimination numerics as Thomas (a symmetric permutation of the
    elimination order), refined to f64 accuracy the same way.

    Per level (0-based, odd rows kept; L[k] = A[k+1,k], U[k] = A[k,k+1]):
        D'_r = D_{2r+1} - L_{2r} Dinv_{2r} U_{2r}
                        - U_{2r+1} Dinv_{2r+2} L_{2r+1}
        L'_r = -L_{2r+2} Dinv_{2r+2} L_{2r+1}
        U'_r = -U_{2r+1} Dinv_{2r+2} U_{2r+2}

    Returns (levels, root): levels a tuple of per-level
    (Dinv_e, G_l, G_r, Lr, Ul) stacks with G_l = L_{2r} Dinv_{2r},
    G_r = U_{2r+1} Dinv_{2r+2}; root the (1, bs, bs) inverse of the last
    remaining block."""
    with _exact_matmul():
        D, L, U = _cr_pad(D, L, U)
        n = D.shape[0]
        levels = []
        while n > 1:
            Dinv_e = _block_inv(D[0::2], blockinv)
            Do = D[1::2]
            Ll, Lr = L[0::2], L[1::2]
            Ul, Ur = U[0::2], U[1::2]
            G_l = Ll @ Dinv_e[:-1]
            G_r = Ur @ Dinv_e[1:]
            D = Do - G_l @ Ul - G_r @ Lr
            L = -(G_l[1:] @ Lr[:-1])
            U = -(G_r[:-1] @ Ul[1:])
            levels.append((Dinv_e, G_l, G_r, Lr, Ul))
            n //= 2
        return tuple(levels), _block_inv(D, blockinv)


def _mv(A, v):
    """Batched (r, i, j) x (r, j) -> (r, i)."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def bt_apply_cr(levels, root, b_blocks):
    """Solve through the CR factors: log-depth rhs reduction, root solve,
    log-depth back-substitution. b_blocks is (nb, bs) in the UNPADDED
    block layout; padding blocks (decoupled identities) get zero rhs."""
    with _exact_matmul():
        n = 2 * levels[0][0].shape[0] - 1
        nb = b_blocks.shape[0]
        b = torch.zeros((n,) + tuple(b_blocks.shape[1:]),
                        dtype=b_blocks.dtype, device=b_blocks.device)
        b[:nb] = b_blocks
        stack = []
        for (Dinv_e, G_l, G_r, Lr, Ul) in levels:
            be = b[0::2]
            stack.append(be)
            b = b[1::2] - _mv(G_l, be[:-1]) - _mv(G_r, be[1:])
        x = _mv(root, b)
        for (Dinv_e, G_l, G_r, Lr, Ul), be in zip(reversed(levels),
                                                  reversed(stack)):
            t = be.clone()
            t[1:] -= _mv(Lr, x)
            t[:-1] -= _mv(Ul, x)
            xe = _mv(Dinv_e, t)
            xn = torch.empty((2 * x.shape[0] + 1,) + tuple(x.shape[1:]),
                             dtype=x.dtype, device=x.device)
            xn[0::2] = xe
            xn[1::2] = x
            x = xn
        return x[:nb]


def bt_solve_cr(levels, root, s, b64, rhs_idx, nb: int, bs: int):
    """f64 rhs -> direction through the CR factors (one pass; factor
    dtype inferred from the level tensors), mirroring bt_solve."""
    bb = _rhs_blocks(s, b64, rhs_idx, nb, bs, root.dtype)
    xb = bt_apply_cr(levels, root, bb).reshape(-1)
    return s * xb[rhs_idx].to(b64.dtype)


def _cr_cast(levels, root, dt):
    return (tuple(tuple(a.to(dt) for a in lv) for lv in levels),
            root.to(dt))


class CRBlockTriFactorization:
    """Cyclic-reduction assembled+factored system — same
    solve(b64)->dx64 interface and dtype contract as
    BlockTriFactorization, selected via pc_factor_algo='cr'."""

    def __init__(self, blocking: LineBlocking, ell, data64, arrays,
                 dtype: str = "f32", apply_dtype: Optional[str] = None,
                 blockinv: str = "ns"):
        _check_apply_dtype(dtype, apply_dtype)
        _check_blockinv(blockinv)
        maps = blocking.device_maps(data64.device)
        D, L, U, s = bt_assemble(data64, arrays["ell_cols"], maps,
                                 blocking.nb, blocking.bs, dtype)
        self.levels, self.root = bt_factor_cr(D, L, U, blockinv)
        if (apply_dtype or dtype) == "f32" and dtype != "f32":
            self.levels, self.root = _cr_cast(self.levels, self.root,
                                              torch.float32)
        self.s = s
        self._rhs_idx = maps["rhs_idx"]
        self._nb, self._bs = blocking.nb, blocking.bs

    def solve(self, b):
        return bt_solve_cr(self.levels, self.root, self.s, b,
                           self._rhs_idx, self._nb, self._bs)


# ----------------------------------------------------- streamed variant

def bt_equilibrate(ell_data, ell_cols, dtype: str = "f32"):
    """Symmetric Jacobi equilibration -> (flat_p, s): flat_p is the
    (N*K+1,) scaled ELL data in the factor dtype with an appended zero
    (the gather target of padded map slots), s the f64 scale as in
    bt_assemble."""
    fdt = _dtype(dtype)
    data_s, s = _equilibrate(ell_data, ell_cols)
    flat_p = torch.cat([data_s.to(fdt).reshape(-1),
                        torch.zeros(1, dtype=fdt, device=ell_data.device)])
    return flat_p, s


def _dense_block(flat_p, src, tgt, bs, pad=None):
    """One (bs, bs) block scattered from the ELL data: out[tgt] =
    flat_p[src], padding slots to the drop position bs*bs; `pad` diagonal
    positions set to 1."""
    bsq = bs * bs
    M = torch.zeros(bsq + 1, dtype=flat_p.dtype, device=flat_p.device)
    M.index_put_((tgt,), flat_p[src])
    if pad is not None:
        M[pad] = 1.0
    return M[:bsq].reshape(bs, bs)


def bt_factor_streamed(flat_p, sm, nb: int, bs: int,
                       blockinv: str = "ns"):
    """Memory-lean block-Thomas factor: only the (nb, bs, bs) Minv stack
    is materialized; D/L/U blocks are scattered from the ELL data inside
    each step and never stored. Live set ~ (nb + 6) bs^2 vs the dense
    path's 5 nb bs^2."""
    Minv = torch.empty((nb, bs, bs), dtype=flat_p.dtype,
                       device=flat_p.device)
    with _exact_matmul():
        Minv[0] = _block_inv(_dense_block(flat_p, sm["d_src"][0],
                                          sm["d_tgt"][0], bs, sm["pad"][0]),
                             blockinv)
        for k in range(1, nb):
            Dk = _dense_block(flat_p, sm["d_src"][k], sm["d_tgt"][k], bs,
                              sm["pad"][k])
            Lk = _dense_block(flat_p, sm["l_src"][k - 1],
                              sm["l_i"][k - 1] * bs + sm["l_j"][k - 1], bs)
            Ukm1 = _dense_block(flat_p, sm["u_src"][k - 1],
                                sm["u_i"][k - 1] * bs + sm["u_j"][k - 1], bs)
            Minv[k] = _block_inv(Dk - Lk @ (Minv[k - 1] @ Ukm1), blockinv)
    return Minv


def _spcoo(flat_p, src, i, j, v, bs):
    """Sparse (bs, bs) block action from the ELL data: out[i] +=
    flat_p[src] * v[j], row bs dropped."""
    out = torch.zeros(bs + 1, dtype=flat_p.dtype, device=flat_p.device)
    out.index_add_(0, i, flat_p[src] * v[j])
    return out[:bs]


def bt_apply_streamed(Minv, flat_p, sm, b_blocks):
    """Forward/back substitution with sparse L/U actions reconstructed
    from the ELL data per step (nothing dense stored beyond Minv):
      fwd: y_k = b_k - L_{k-1} (Minv_{k-1} y_{k-1})
      bwd: x_k = Minv_k (y_k - U_k x_{k+1})
    """
    nb, bs = Minv.shape[0], Minv.shape[1]
    y = torch.empty_like(b_blocks)
    x = torch.empty_like(b_blocks)
    with _exact_matmul():
        y[0] = b_blocks[0]
        for k in range(1, nb):
            t = Minv[k - 1] @ y[k - 1]
            y[k] = b_blocks[k] - _spcoo(flat_p, sm["l_src"][k - 1],
                                        sm["l_i"][k - 1], sm["l_j"][k - 1],
                                        t, bs)
        x[nb - 1] = Minv[nb - 1] @ y[nb - 1]
        for k in range(nb - 2, -1, -1):
            x[k] = Minv[k] @ (y[k] - _spcoo(flat_p, sm["u_src"][k],
                                            sm["u_i"][k], sm["u_j"][k],
                                            x[k + 1], bs))
    return x


def bt_solve_streamed(Minv, flat_p, s, b64, rhs_idx, sm, nb: int, bs: int):
    bb = _rhs_blocks(s, b64, rhs_idx, nb, bs, flat_p.dtype)
    xb = bt_apply_streamed(Minv, flat_p, sm, bb).reshape(-1)
    return s * xb[rhs_idx].to(b64.dtype)


class StreamedBlockTriFactorization:
    """Memory-lean assembled+factored system (see bt_factor_streamed):
    same solve(b64)->dx64 interface as BlockTriFactorization."""

    def __init__(self, blocking: LineBlocking, ell, data64, arrays,
                 dtype: str = "f32", apply_dtype: Optional[str] = None,
                 blockinv: str = "ns"):
        _check_apply_dtype(dtype, apply_dtype)
        _check_blockinv(blockinv)
        dev = data64.device
        self._sm = blocking.streamed_maps(dev)
        self.flat_p, self.s = bt_equilibrate(data64, arrays["ell_cols"],
                                             dtype)
        self.Minv = bt_factor_streamed(self.flat_p, self._sm,
                                       blocking.nb, blocking.bs, blockinv)
        if (apply_dtype or dtype) == "f32" and dtype != "f32":
            # see BlockTriFactorization: f64 factor, f32 apply
            self.Minv = self.Minv.to(torch.float32)
            self.flat_p = self.flat_p.to(torch.float32)
        # only rhs_idx — device_maps() would move the three full-nnz dense
        # scatter maps the streamed path exists to avoid
        self._rhs_idx = torch.as_tensor(blocking.rhs_idx.astype(np.int64),
                                        device=dev)
        self._nb, self._bs = blocking.nb, blocking.bs

    def solve(self, b):
        return bt_solve_streamed(self.Minv, self.flat_p, self.s, b,
                                 self._rhs_idx, self._sm,
                                 self._nb, self._bs)


# ------------------------------------------- choice of layout, refinement

def factorization(blocking: LineBlocking, dtype: str, algo: str = "thomas",
                  streamed: bool = False):
    """The factorization class for `blocking` at factor dtype `dtype`:
    streamed when forced or when the dense factor tensors exceed
    LineBlocking.max_bytes at the factor's own itemsize, else dense Thomas
    or cyclic reduction (`algo`). Raises ValueError, as the reference does,
    for an unknown algo, for factors too large even streamed, and for
    cyclic reduction on the streamed layout (which only implements the
    Thomas recursion)."""
    if algo not in ("thomas", "cr"):
        raise ValueError(f"pc_factor_algo must be 'thomas' or 'cr', "
                         f"got {algo!r}")
    isz = 8 if dtype == "f64" else 4
    streamed = streamed or not blocking.fits_dense(isz, algo)
    if streamed and not blocking.fits_streamed(isz):
        raise ValueError(
            f"block-tridiagonal factors too large even streamed at "
            f"{isz}-byte factor dtype: nb={blocking.nb} bs={blocking.bs}")
    if streamed:
        if algo == "cr":
            raise ValueError(
                "pc_factor_algo='cr' is incompatible with the streamed "
                "factor layout (dense factors exceed LineBlocking.max_bytes "
                "or pc_factor_streamed was set); use 'thomas'")
        return StreamedBlockTriFactorization
    return CRBlockTriFactorization if algo == "cr" else BlockTriFactorization


def refine(solve: Callable, Av: Callable, b, stop2, passes: int,
           stop_on_nan: bool = True, on_pass: Optional[Callable] = None):
    """Iterative refinement of a factor's `solve` against the operator
    `Av`: dx = solve(b), then dx += solve(b - Av(dx)) while the squared
    residual is above `stop2`, still contracting (by 0.7 a pass, 0.49 on
    the square) and fewer than `passes` corrections were made. A NaN
    residual ends it when `stop_on_nan`, else it refines on, as the
    reference's fixed-budget scan does. A `while_loop` with chunk 1: one
    host read a pass. on_pass(p, rn2), if given, sees each tested residual.

    -> (dx, reached, p): reached (0-dim bool tensor) whether the last
    residual is within stop2, p the number of corrections made. Each
    factor apply is the span `bt.apply`, counting one `bt.apply_kernel`
    where the kernel of ops/btapply served it, each residual
    `bt.residual`, and each correction counts one `bt.refine_passes`."""
    def apply(v):
        with span("bt.apply"):
            n0 = bt_apply.launches
            z = solve(v)
            if bt_apply.launches != n0:
                count("bt.apply_kernel")
            return z

    def residual(dx):
        with span("bt.residual"):
            return b - Av(dx)

    dx = apply(b)
    r = residual(dx)
    inf = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
    i0 = torch.zeros((), dtype=torch.int64, device=b.device)

    def cond(c):
        p, _, _, rn2, rn2_prev = c
        if on_pass is not None:
            count("host_reads", 2)
            on_pass(int(p), float(rn2))
        live = (p < passes) & ~(rn2 <= stop2) & ~(rn2 > 0.49 * rn2_prev)
        return live & torch.isfinite(rn2) if stop_on_nan else live

    def body(c):
        p, dx, r, rn2, _ = c
        count("bt.refine_passes")
        dx = dx + apply(r)
        r = residual(dx)
        return p + 1, dx, r, torch.dot(r, r), rn2

    p, dx, _, rn2, _ = while_loop(cond, body,
                                  (i0, dx, r, torch.dot(r, r), inf), chunk=1)
    return dx, rn2 <= stop2, p
