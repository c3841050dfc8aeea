"""Volume-form assembly as batched tensor contractions, in PyTorch.

The counterpart of the reference's UFL -> FFCx -> C kernel -> PETSc
assembly pipeline (exercised from src/lvpp/problem.py:54-77):

  * A problem is defined by a *pointwise* residual function evaluated at
    quadrature points; `torch.func.jvp`/`torch.func.jacfwd` of that
    function replace `ufl.derivative` (the symbolic Gateaux derivative).
  * Field evaluation, physics and test-function contraction are einsums
    over (cells, quadrature points). The user's pointwise function runs
    under `torch.func.vmap` over all points of a cell block.
  * The Jacobian never needs to be materialized: its action is the jvp of
    the assembled residual (cost ≈ 2 residuals), feeding matrix-free
    Krylov. Explicit element matrices / ELL / scipy CSR are available for
    the device Krylov operator, the host sparse LU (standing in for MUMPS)
    and preconditioners.
  * Cells are processed in blocks (ELEMENT_MATRIX_CHUNK, RESIDUAL_CHUNK)
    to bound the working set; the block size changes only the rounding
    of the sums.

Residual convention: for test function v of field f,
    F_f(v) = ∫ a0_f · v + a1_f : grad(v) dx
where the user's pointwise function returns {field: (a0, a1)} given
(x, values, gradients, coefficients, coefficient gradients, constants).
It is written against torch: torch.exp, torch.where, (a * b).sum(-1) for
a dot product; no data-dependent Python control flow and no in-place ops,
which torch.func refuses.
"""

from __future__ import annotations

from functools import cached_property
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from ..core.logging import count, span
from ..elements.quadrature import cell_quadrature
from ..spaces.space import MixedSpace
from .geometry import cell_geometry


class VolumeForm:
    """Assembler for ∫ ... dx over all cells of the mesh of a MixedSpace.

    Args:
      space: the mixed function space of the unknowns.
      residual_fn: pointwise residual
          fn(x, u, gu, c, gc, consts) -> {field: (a0, a1 | None)}
        with x (gdim,), u[f] scalar or (m,), gu[f] (gdim,) or (m, gdim);
        coefficient values c[name] and gradients gc[name] analogous (gc[name]
        is None for raw quadrature-point coefficients).
      quadrature_degree: polynomial degree the rule integrates exactly
        (reference uses 6 for the obstacle problem, obstacle_pg.py:106).
      coeff_spaces: {name: FunctionSpace} for FE-function coefficients
        (e.g. the previous LVPP iterate psi_k); other coefficient entries
        passed at call time are treated as raw per-quadrature-point arrays
        of shape (ncells, nq, ...) (the quadrature-element obstacle phi,
        obstacle_pg.py:106-111).
      jacobian_fn: optional pointwise residual whose derivative defines
        every Jacobian path while residual_fn defines F (an explicit J
        passed to SNESProblem, reference problem.py:19,40-49).
      dtype, device: of every tensor the form makes.
    """

    # Cell-block sizes of the chunked assembly (the reference's lax.map
    # blocks, kept as they are): they bound the (cells, nq, ...)
    # intermediates; any block size gives the same results up to the
    # rounding of the einsums' sums.
    ELEMENT_MATRIX_CHUNK = 2048
    RESIDUAL_CHUNK = 16384

    def __init__(self, space: MixedSpace, residual_fn: Callable,
                 quadrature_degree: int,
                 coeff_spaces: Optional[Mapping[str, object]] = None,
                 jacobian_fn: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float64, device="cuda"):
        self.space = space
        self.residual_fn = residual_fn
        self.jacobian_fn = jacobian_fn
        self.coeff_spaces = dict(coeff_spaces or {})
        self.dtype = dtype
        self.device = torch.device(device)
        mesh = space.mesh
        self.mesh = mesh
        self.qpts, self.qw = cell_quadrature(mesh.cell_type, quadrature_degree)
        self.nq = len(self.qw)
        geom = cell_geometry(mesh, self.qpts, self.qw)
        self.gdim, self.tdim = mesh.gdim, mesh.tdim
        self._xq_host = np.asarray(geom.x)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        def ti(a):
            return torch.as_tensor(a, dtype=torch.int64, device=self.device)

        self.tab: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.field_m: Dict[str, int] = {}
        self.coeff_tab: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.coeff_m: Dict[str, int] = {}
        self._gather_host: Dict[str, np.ndarray] = {}
        coeff_idx = {}
        for name in space.names:
            fs = space.spaces[name]
            phi, dphi = fs.element.tabulate(self.qpts)
            self.tab[name] = (t(phi), t(dphi))
            m = fs.value_size
            self.field_m[name] = m
            dm = fs.dofmap.astype(np.int64)
            self._gather_host[name] = (space.offsets[name] + dm[:, :, None] * m
                                       + np.arange(m)[None, None, :])
        for name, fs in self.coeff_spaces.items():
            phi, dphi = fs.element.tabulate(self.qpts)
            self.coeff_tab[name] = (t(phi), t(dphi))
            m = fs.value_size
            self.coeff_m[name] = m
            dm = fs.dofmap.astype(np.int64)
            coeff_idx[name] = ti(dm[:, :, None] * m
                                 + np.arange(m)[None, None, :])

        self.cell_data: Dict[str, object] = {
            "xq": t(geom.x),                   # (e, q, gdim)
            "wdet": t(geom.wdet),              # (e, q)
            "G": t(geom.G),                    # (e, q, gdim, tdim)
            "gather_idx": {k: ti(v) for k, v in self._gather_host.items()},
            "coeff_idx": coeff_idx,
        }

    # convenience accessors
    @property
    def xq(self):
        return self.cell_data["xq"]

    @property
    def wdet(self):
        return self.cell_data["wdet"]

    @property
    def G(self):
        return self.cell_data["G"]

    @property
    def gather_idx(self):
        return self.cell_data["gather_idx"]

    @property
    def coeff_idx(self):
        return self.cell_data["coeff_idx"]

    def _as(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ evaluation

    def _eval_field(self, name: str, x, data):
        """vals (e,q,m), phys grads (e,q,m,gdim) of field `name` from the
        global mixed vector x."""
        phi, dphi = self.tab[name]
        zc = x[data["gather_idx"][name]]             # (e, i, m)
        vals = torch.einsum("qi,eim->eqm", phi, zc)
        rg = torch.einsum("qit,eim->eqmt", dphi, zc)
        grads = torch.einsum("eqdt,eqmt->eqmd", data["G"], rg)
        return vals, grads

    def _eval_coeff(self, name: str, z, data):
        phi, dphi = self.coeff_tab[name]
        zc = z[data["coeff_idx"][name]]
        vals = torch.einsum("qi,eim->eqm", phi, zc)
        rg = torch.einsum("qit,eim->eqmt", dphi, zc)
        grads = torch.einsum("eqdt,eqmt->eqmd", data["G"], rg)
        return vals, grads

    def _prepare_coeffs(self, coeffs, data):
        """Split user coefficients into per-quad-point (vals, grads|None)."""
        cv, cg = {}, {}
        for name, arr in (coeffs or {}).items():
            if name in self.coeff_tab:
                cv[name], cg[name] = self._eval_coeff(name, self._as(arr),
                                                      data)
            else:
                a = self._as(arr)
                if a.ndim == 2:   # (e, q) scalar coefficient
                    a = a[:, :, None]
                cv[name], cg[name] = a, None
        return cv, cg

    def _fields(self, x, coeffs, data):
        vals, grads = {}, {}
        for f in self.space.names:
            vals[f], grads[f] = self._eval_field(f, x, data)
        cv, cg = self._prepare_coeffs(coeffs, data)
        return vals, grads, cv, cg

    # ------------------------------------------------- pointwise call (user)

    def _user_shapes(self, vals, grads):
        u, gu = {}, {}
        for f, m in self.field_m.items():
            if m == 1:
                u[f] = vals[f][0]
                gu[f] = grads[f][0]
            else:
                u[f] = vals[f]
                gu[f] = grads[f]
        return u, gu

    def _user_coeff_shapes(self, cvals, cgrads):
        c = {k: (v[0] if tuple(v.shape) == (1,) else v)
             for k, v in cvals.items()}
        gc = {k: (None if g is None else (g[0] if g.shape[0] == 1 and
                                          self.coeff_m.get(k, 1) == 1 else g))
              for k, g in cgrads.items()}
        return c, gc

    def _canon(self, out):
        """User output {f: (a0, a1)} -> flat tuple (a0_f (m,), a1_f
        (m, gdim)) in space order."""
        res = []
        for f, m in self.field_m.items():
            a0, a1 = out.get(f, (None, None))
            if a0 is None:
                a0c = torch.zeros((m,), dtype=self.dtype, device=self.device)
            else:
                a0c = self._as(a0)
                a0c = a0c.reshape(m) if a0c.ndim <= 1 else a0c
            if a1 is None:
                a1c = torch.zeros((m, self.gdim), dtype=self.dtype,
                                  device=self.device)
            else:
                a1c = self._as(a1).reshape(m, self.gdim)
            res += [a0c, a1c]
        return tuple(res)

    def _point_args(self, data, vals, grads, cv, cg):
        """Flatten the (cells, points) axes: (xq, field values, field
        gradients, coefficient values, coefficient gradients), each with a
        leading axis of e*q points; the coefficient gradients list holds
        only the coefficients that have one."""
        e, q = data["wdet"].shape
        flat = lambda a: a.reshape((e * q,) + tuple(a.shape[2:]))
        names = self.space.names
        cnames = list(cv)
        gnames = [k for k in cnames if cg[k] is not None]
        args = ([flat(vals[f]) for f in names] + [flat(grads[f]) for f in names]
                + [flat(cv[k]) for k in cnames] + [flat(cg[k]) for k in gnames])
        return flat(data["xq"]), args, cnames, gnames

    def _point_fn(self, cnames, gnames, consts, fn, canon=True):
        """call(xq, field values, field gradients, coefficient values,
        coefficient gradients) -> the pointwise function `fn` at one point
        (its flat canonical output, or with canon=False its scalar), and
        split(rest) cutting _point_args' flat argument list into those
        four groups."""
        nf, nc = len(self.space.names), len(cnames)
        names = self.space.names

        def call(xq, svs, sgs, cvs, cgs):
            u, gu = self._user_shapes(dict(zip(names, svs)),
                                      dict(zip(names, sgs)))
            cgq = dict(zip(gnames, cgs))
            c, gc = self._user_coeff_shapes(
                dict(zip(cnames, cvs)), {k: cgq.get(k) for k in cnames})
            out = fn(xq, u, gu, c, gc, consts)
            return self._canon(out) if canon else self._as(out)

        def split(rest):
            return (rest[:nf], rest[nf:2 * nf], rest[2 * nf:2 * nf + nc],
                    rest[2 * nf + nc:])
        return call, split

    def _pointwise_values(self, data, vals, grads, cv, cg, consts, fn):
        """{f: (a0 (e,q,m), a1 (e,q,m,gdim))} of `fn` at every point."""
        e, q = data["wdet"].shape
        xq, args, cnames, gnames = self._point_args(data, vals, grads, cv, cg)
        call, split = self._point_fn(cnames, gnames, consts, fn)
        out = vmap(lambda xp, *rest: call(xp, *split(rest)))(xq, *args)
        res = {}
        for i, f in enumerate(self.space.names):
            a0, a1 = out[2 * i], out[2 * i + 1]
            res[f] = (a0.reshape((e, q) + tuple(a0.shape[1:])),
                      a1.reshape((e, q) + tuple(a1.shape[1:])))
        return res

    def _pointwise_jacobian(self, data, vals, grads, cv, cg, consts, fn):
        """K[f] = ((dict g: d a0_f/d val_g, dict g: d a0_f/d grad_g),
        (dict g: d a1_f/d val_g, dict g: d a1_f/d grad_g)) at every point,
        each with leading axes (e, q) — the layout of the reference's
        jacfwd over (vals, grads)."""
        e, q = data["wdet"].shape
        names = self.space.names
        nf = len(names)
        xq, args, cnames, gnames = self._point_args(data, vals, grads, cv, cg)
        call, split = self._point_fn(cnames, gnames, consts, fn)

        def pw_jac(xp, *rest):
            svs, sgs, cvs, cgs = split(rest)

            def g(*s):
                return call(xp, s[:nf], s[nf:], cvs, cgs)
            return jacfwd(g, argnums=tuple(range(2 * nf)))(*svs, *sgs)

        J = vmap(pw_jac)(xq, *args)
        unflat = lambda a: a.reshape((e, q) + tuple(a.shape[1:]))
        K = {}
        for i, f in enumerate(names):
            K[f] = tuple(
                ({g: unflat(J[2 * i + o][j]) for j, g in enumerate(names)},
                 {g: unflat(J[2 * i + o][nf + j]) for j, g in enumerate(names)})
                for o in (0, 1))
        return K

    # ------------------------------------------------------- cell blocks

    def _blocks(self, coeffs, data, chunk):
        """(coeffs, data) of each cell block of at most `chunk` cells, in
        cell order. FE-coefficient vectors pass through whole; per-cell
        quadrature coefficient arrays are sliced with the data."""
        coeffs = dict(coeffs or {})
        e = data["wdet"].shape[0]
        if e <= chunk:
            yield coeffs, data
            return
        raw = {k: self._as(v) for k, v in coeffs.items()
               if k not in self.coeff_tab}
        fe = {k: v for k, v in coeffs.items() if k in self.coeff_tab}

        def sl(a, lo, hi):
            if isinstance(a, dict):
                return {k: sl(v, lo, hi) for k, v in a.items()}
            return a[lo:hi]

        for lo in range(0, e, chunk):
            hi = min(lo + chunk, e)
            yield ({**fe, **{k: v[lo:hi] for k, v in raw.items()}},
                   sl(data, lo, hi))

    # ---------------------------------------------------------- residual

    def _residual_core(self, x, coeffs, consts, data=None, out_size=None,
                       fn: Optional[Callable] = None):
        data = self.cell_data if data is None else data
        fn = fn or self.residual_fn
        x = self._as(x)
        F = torch.zeros(out_size or self.space.num_dofs, dtype=self.dtype,
                        device=self.device)
        for c, d in self._blocks(coeffs, data, self.RESIDUAL_CHUNK):
            F = self._residual_block(x, c, consts, d, F, fn)
        return F

    def _residual_block(self, x, coeffs, consts, data, F, fn):
        vals, grads, cv, cg = self._fields(x, coeffs, data)
        t = self._pointwise_values(data, vals, grads, cv, cg, consts, fn)
        wdet, G = data["wdet"], data["G"]
        for f in self.space.names:
            phi, dphi = self.tab[f]
            a0, a1 = t[f]                            # (e,q,m), (e,q,m,gdim)
            wa0 = a0 * wdet[:, :, None]
            wa1 = torch.einsum("eqdt,eqmd->eqmt", G,
                               a1 * wdet[:, :, None, None])
            r = (torch.einsum("qi,eqm->eim", phi, wa0)
                 + torch.einsum("qit,eqmt->eim", dphi, wa1))
            F = F.index_add(0, data["gather_idx"][f].reshape(-1),
                            r.reshape(-1))
        return F

    def residual(self, x, coeffs=None, consts=None) -> torch.Tensor:
        return self._residual_core(x, coeffs or {}, consts or {})

    # ------------------------------------------------- matrix-free Jacobian

    def _jacobian_residual_core(self, x, coeffs, consts, data=None,
                                out_size=None):
        """Residual whose derivative defines the Jacobian (may differ from
        the true residual when jacobian_fn is set)."""
        return self._residual_core(x, coeffs, consts, data, out_size,
                                   self.jacobian_fn)

    def jacobian_action(self, x, v, coeffs=None, consts=None) -> torch.Tensor:
        """J(x) @ v without materializing J (replaces assemble_matrix+MatMult)."""
        coeffs, consts = coeffs or {}, consts or {}
        return jvp(lambda y: self._jacobian_residual_core(y, coeffs, consts),
                   (self._as(x),), (self._as(v),))[1]

    # ------------------------------------------------- element matrices

    def _element_matrices_core(self, x, coeffs, consts, data=None):
        """Full mixed element matrices (e, L, L), L = sum_f nl_f * m_f,
        local ordering = fields in space order, each (i, comp) interleaved.
        Large meshes are processed in cell blocks to bound the jacfwd-einsum
        working set."""
        data = self.cell_data if data is None else data
        x = self._as(x)
        with span("element_matrices"):
            parts = [self._element_matrices_block(x, c, consts, d)
                     for c, d in self._blocks(coeffs, data,
                                              self.ELEMENT_MATRIX_CHUNK)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _gphi(self, f, G):
        return torch.einsum("eqdt,qit->eqid", G, self.tab[f][1])

    def _element_matrices_block(self, x, coeffs, consts, data):
        vals, grads, cv, cg = self._fields(x, coeffs, data)
        K = self._pointwise_jacobian(data, vals, grads, cv, cg, consts,
                                     self.jacobian_fn or self.residual_fn)
        G, w = data["G"], data["wdet"]
        gphi = {f: self._gphi(f, G) for f in self.space.names}
        rows = []
        for f in self.space.names:
            phif = self.tab[f][0]
            gpf = gphi[f]
            (K0, K1) = K[f]
            row = []
            for g in self.space.names:
                phig = self.tab[g][0]
                gpg = gphi[g]
                K00 = K0[0][g] * w[:, :, None, None]
                K01 = K0[1][g] * w[:, :, None, None, None]
                K10 = K1[0][g] * w[:, :, None, None, None]
                K11 = K1[1][g] * w[:, :, None, None, None, None]
                t1 = torch.einsum("qi,eqab,qj->eiajb", phif, K00, phig)
                t2 = torch.einsum("qi,eqabd,eqjd->eiajb", phif, K01, gpg)
                t3 = torch.einsum("eqid,eqadb,qj->eiajb", gpf, K10, phig)
                t4 = torch.einsum("eqid,eqadbc,eqjc->eiajb", gpf, K11, gpg)
                A = t1 + t2 + t3 + t4
                e, nlf, mf, nlg, mg = A.shape
                row.append(A.reshape(e, nlf * mf, nlg * mg))
            rows.append(torch.cat(row, dim=2))
        return torch.cat(rows, dim=1)

    def element_matrices(self, x, coeffs=None, consts=None) -> torch.Tensor:
        return self._element_matrices_core(x, coeffs or {}, consts or {})

    @cached_property
    def local_indices(self) -> np.ndarray:
        """(e, L) global dof for each local mixed slot (field-concatenated)."""
        per = [self._gather_host[f].reshape(self.mesh.num_cells, -1)
               for f in self.space.names]
        return np.concatenate(per, axis=1)

    def assemble_scipy(self, x, coeffs=None, consts=None, timer=None):
        """Assembled CSR matrix on host (the MUMPS-replacement LU path for
        small/medium systems and verification). With a PhaseTimer, the
        device element matrices, the copy to the host and the COO sum are
        timed as 'assembly', 'host_transfer' and 'csr'."""
        import contextlib
        import scipy.sparse as sp
        phase = (timer.phase if timer is not None
                 else lambda name: contextlib.nullcontext())
        with phase("assembly"):
            Ae = self.element_matrices(x, coeffs, consts)
        with phase("host_transfer"):
            count("host_reads")
            Ae = Ae.cpu().numpy()
        with phase("csr"):
            gi = self.local_indices
            L = gi.shape[1]
            rows = np.repeat(gi, L, axis=1).reshape(-1)
            cols = np.tile(gi, (1, L)).reshape(-1)
            N = self.space.num_dofs
            A = sp.coo_matrix((Ae.reshape(-1), (rows, cols)), shape=(N, N))
            return A.tocsr()

    # ------------------------------------------------------------ diagonal

    def _diagonal_core(self, x, coeffs, consts, data=None, out_size=None):
        """Jacobian diagonal without materializing element matrices —
        O(ncells * nq * m^2 * d^2) memory, the Jacobi-preconditioner path
        for large systems."""
        data = self.cell_data if data is None else data
        x = self._as(x)
        out = torch.zeros(out_size or self.space.num_dofs, dtype=self.dtype,
                          device=self.device)
        for c, d in self._blocks(coeffs, data, self.ELEMENT_MATRIX_CHUNK):
            out = self._diagonal_block(x, c, consts, d, out)
        return out

    def _diagonal_block(self, x, coeffs, consts, data, out):
        vals, grads, cv, cg = self._fields(x, coeffs, data)
        K = self._pointwise_jacobian(data, vals, grads, cv, cg, consts,
                                     self.jacobian_fn or self.residual_fn)
        G, w = data["G"], data["wdet"]
        for f in self.space.names:
            phi = self.tab[f][0]
            gphi = self._gphi(f, G)
            (K0, K1) = K[f]
            K00d = torch.diagonal(K0[0][f], dim1=2, dim2=3)       # eqa
            K01d = torch.diagonal(K0[1][f], dim1=2, dim2=3).movedim(-1, 2)
            K10d = torch.diagonal(K1[0][f], dim1=2, dim2=4).movedim(-1, 2)
            K11d = torch.diagonal(K1[1][f], dim1=2, dim2=4).movedim(-1, 2)
            t1 = torch.einsum("qi,qi,eq,eqa->eia", phi, phi, w, K00d)
            t2 = torch.einsum("qi,eqid,eq,eqad->eia", phi, gphi, w,
                              K01d + K10d)
            t4 = torch.einsum("eqid,eqadc,eq,eqic->eia", gphi, K11d, w, gphi)
            d = t1 + t2 + t4                         # (e, i, a)
            out = out.index_add(0, data["gather_idx"][f].reshape(-1),
                                d.reshape(-1))
        return out

    def jacobian_diagonal(self, x, coeffs=None, consts=None) -> torch.Tensor:
        """Diagonal of the assembled Jacobian (Jacobi preconditioning)."""
        return self._diagonal_core(x, coeffs or {}, consts or {})

    # ------------------------------------------------------- functionals

    def make_functional_core(self, fn: Callable) -> Callable:
        """The data-parameterized core of make_functional:
        (x, coeffs, consts, data) -> scalar tensor."""

        def functional_core(x, coeffs, consts, data):
            vals, grads, cv, cg = self._fields(self._as(x), coeffs, data)
            e, q = data["wdet"].shape
            xq, args, cnames, gnames = self._point_args(data, vals, grads,
                                                        cv, cg)
            call, split = self._point_fn(cnames, gnames, consts or {}, fn,
                                         canon=False)
            vq = vmap(lambda xp, *rest: call(xp, *split(rest)))(xq, *args)
            return torch.sum(vq.reshape(e, q) * data["wdet"])

        return functional_core

    def make_functional(self, fn: Callable) -> Callable:
        """A scalar functional ∫ fn(x, u, gu, c, gc, consts) dx — the
        observables of the reference (energy, complementarity,
        feasibility, increments; obstacle_pg.py:145-152)."""
        core = self.make_functional_core(fn)

        def functional(x, coeffs=None, consts=None):
            return core(x, coeffs or {}, consts or {}, self.cell_data)

        return functional

    def interpolate_to_quadrature(self, fn: Callable) -> np.ndarray:
        """Evaluate a host function f(x:(gdim,npts)) at all physical
        quadrature points -> (ncells, nq) array (the quadrature-element
        interpolation of the obstacle, obstacle_pg.py:106-111)."""
        xq = self._xq_host
        flat = xq.reshape(-1, self.gdim).T
        return np.asarray(fn(flat)).reshape(xq.shape[0], xq.shape[1])
