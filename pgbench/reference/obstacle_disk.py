"""Plain reference of the general LVPP stack on example 01's disk: the
same LVPP iteration written again in NumPy and SciPy, with its own
assembly and a host sparse LU, from the benchmark's mesh and obstacle.

The problem (obstacle_pg.py:116-124), P1 for u and psi, quadrature of
the configured degree, u = 0 on the boundary:

    F_u   = alpha (grad u, grad v) + (psi - psi_k, v)
    F_psi = (u - exp(psi) - phi, w)

outer steps alpha_k = min(max(C r^(q^k) - alpha_{k-1}, C), alpha_max)
until the H1 increment of u falls under tol_exit; each step's Newton
(no line search) stops when |F| <= snes_rtol |F_0| or the step is under
snes_stol |x|. The answers are compared with the reference's solution:

  u_gap       max |u - u_ref| / max |u_ref|
  latent_gap  max |exp(psi) - exp(psi_ref)| / max |u_ref|, the latent
              field's image (psi itself falls without bound where the
              obstacle is in contact, by a step that depends on alpha)

In float32 (the control) the Newton step test `|dx| < snes_stol |x|`
is floored at 16 machine epsilons, which float32 can meet; the
iteration is otherwise the same.

Limits: set from the program's readings over a dozen seeds and the
control's (the program's own float32 path) at the cell's size on an
H100; see PERF.md.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pgbench.reference import _p1

LIMITS = {"u_gap": 1e-5, "latent_gap": 1e-4}


class Disk:
    """The assembled pieces of one mesh and obstacle in `dtype`."""

    def __init__(self, points, cells, centre, degree, dtype=np.float64):
        cells = cells.astype(np.int64)
        n = len(points)
        self.n, self.cells, self.dtype = n, cells, dtype
        area, _ = _p1.gradients(points, cells)
        Ke = _p1.stiffness_elements(points, cells)
        q, w = _p1.triangle_rule(degree)
        # linear basis at the quadrature points (nq, 3)
        self.B = np.stack([1.0 - q[:, 0] - q[:, 1], q[:, 0], q[:, 1]], 1)
        self.wq = 2.0 * area[:, None] * w[None, :]          # (e, nq)
        Me = np.einsum("eq,qi,qj->eij", self.wq, self.B, self.B)
        p = points[cells]
        xq = np.einsum("qi,eid->eqd", self.B, p)            # (e, nq, 2)
        phiq = _p1.cap(xq.reshape(-1, 2).T, centre).reshape(xq.shape[:2])
        rows = np.repeat(cells, 3, axis=1).reshape(-1)
        cols = np.tile(cells, (1, 3)).reshape(-1)
        self.rows, self.cols = rows, cols
        self.K = sp.csr_matrix((Ke.reshape(-1), (rows, cols)), shape=(n, n))
        self.M = sp.csr_matrix((Me.reshape(-1), (rows, cols)), shape=(n, n))
        self.bphi = np.bincount(cells.reshape(-1), minlength=n, weights=(
            self.wq[:, :, None] * phiq[:, :, None] * self.B[None]
        ).sum(1).reshape(-1))
        self.bc = _p1.boundary_vertices(cells, n)
        self.free = np.ones(2 * n, dtype=bool)
        self.free[self.bc] = False
        self.K = self.K.astype(dtype)
        self.M = self.M.astype(dtype)
        self.bphi = self.bphi.astype(dtype)

    def exp_terms(self, psi):
        """(b (n,), E (n, n)): the vectors (exp(psi), w) and the matrix
        (exp(psi) v, w) by quadrature."""
        eq = np.exp(np.einsum("qi,ei->eq", self.B, psi[self.cells]))
        we = self.wq * eq
        b = np.bincount(self.cells.reshape(-1), minlength=self.n,
                        weights=np.einsum("eq,qi->ei", we, self.B).ravel())
        Ee = np.einsum("eq,qi,qj->eij", we, self.B, self.B)
        E = sp.csr_matrix((Ee.reshape(-1), (self.rows, self.cols)),
                          shape=(self.n, self.n))
        return b.astype(self.dtype), E.astype(self.dtype)

    def residual(self, x, psi_k, alpha):
        n = self.n
        u, psi = x[:n], x[n:]
        b, E = self.exp_terms(psi)
        Fu = alpha * (self.K @ u) + self.M @ (psi - psi_k)
        Fp = self.M @ u - b - self.bphi
        F = np.concatenate([Fu, Fp]).astype(self.dtype)
        F[self.bc] = x[self.bc]
        return F, E

    def jacobian(self, alpha, E):
        J = sp.bmat([[alpha * self.K, self.M], [self.M, -E]], format="csr")
        # symmetric Dirichlet rows and columns of u
        P = sp.diags(self.free.astype(self.dtype))
        Q = sp.diags((~self.free).astype(self.dtype))
        return (P @ J @ P + Q).astype(self.dtype).tocsc()


def lvpp(disk: Disk, lv: dict, newton: dict) -> dict:
    """The LVPP solve from zeros; returns u, psi and its counts."""
    dt = disk.dtype
    n = disk.n
    stol = max(newton["snes_stol"], 16.0 * float(np.finfo(dt).eps))
    C, r, q = 1.0, 1.5, 1.5
    x_k = np.zeros(2 * n, dtype=dt)
    prev = 1.0
    steps, converged = [], False
    for k in range(lv["max_outer"]):
        try:
            a = max(C * r ** (q ** k) - prev, C)
        except OverflowError:
            a = lv["alpha_max"]
        prev = a
        alpha = dt(min(a, lv["alpha_max"]))
        psi_k = x_k[n:].copy()
        x = x_k.copy()
        F, E = disk.residual(x, psi_k, alpha)
        f0 = float(np.linalg.norm(F))
        its, ok = 0, f0 < newton["snes_atol"]
        while not ok and its < newton["snes_max_it"]:
            dx = spla.splu(disk.jacobian(alpha, E)).solve(-F).astype(dt)
            x = (x + dx).astype(dt)
            F, E = disk.residual(x, psi_k, alpha)
            its += 1
            fn = float(np.linalg.norm(F))
            if not np.isfinite(fn):
                break
            ok = (fn < newton["snes_atol"] or fn <= newton["snes_rtol"] * f0
                  or np.linalg.norm(dx) < stol * max(float(np.linalg.norm(x)), 1e-300))
        if not ok:
            break
        du = (x - x_k)[:n]
        inc = float(np.sqrt(max(du @ (disk.K @ du) + du @ (disk.M @ du),
                                0.0)))
        steps.append(its)
        x_k = x
        if inc < lv["tol_exit"]:
            converged = True
            break
    return {"u": x_k[:n].astype(np.float64),
            "psi": x_k[n:].astype(np.float64),
            "newton": steps, "converged": converged}


def newton_options(config: dict) -> dict:
    o = dict(config["newton"])
    return {k: float(o[k]) for k in ("snes_rtol", "snes_atol", "snes_stol")} \
        | {"snes_max_it": int(o["snes_max_it"])}


def solve(inputs, config: dict, dtype=np.float64) -> dict:
    lv = config["lvpp"]
    disk = Disk(inputs.points, inputs.cells, inputs.centre,
                lv["quadrature_degree"], dtype)
    return lvpp(disk, lv, newton_options(config))


def numbers(ref: dict, fields: dict) -> dict:
    """One answer's gaps to the reference's solution `ref`."""
    u, psi = fields["u"], fields["psi"]
    scale = max(np.abs(ref["u"]).max(), 1e-300)
    du = np.abs(u - ref["u"]).max() / scale
    dl = np.abs(np.exp(np.minimum(psi, 700.0))
                - np.exp(np.minimum(ref["psi"], 700.0))).max() / scale
    return {"u_gap": float(du), "latent_gap": float(dl)}


def prepare(inputs, config: dict) -> dict:
    """The reference's own solution of the cell's problem."""
    return solve(inputs, config)

