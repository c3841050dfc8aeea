"""Exterior-facet (ds) assembly, in PyTorch.

The port of the reference package's assembly/facets.py, the rebuild of
DOLFINx's exterior-facet integrals (`ds` measures) needed by the Signorini
contact terms (signorini_dolfinx.py:244-249, latent coupling on the
contact boundary) and boundary observables.

Geometry and basis tables are built on the host in numpy, as in the
reference: facets are grouped by their local index within the owning cell
(a static, small set); quadrature points on the reference facet are mapped
into the owning cell's reference coordinates; the surface measure is the
Gram determinant of the facet tangent map, and outward normals come from
the cell Jacobian and the reference outward normal. The tables then live
on `device`; the user's pointwise function runs under `torch.func.vmap`
over the flattened (facet, quadrature point) axis, `torch.func.jacfwd` of
it gives the facet element matrices, and the residual scatters with
`index_add`, as VolumeForm does.
"""

from __future__ import annotations

from functools import cached_property
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..elements.lagrange import lagrange_element
from ..elements.quadrature import cell_quadrature
from ..spaces.space import MixedSpace


def _facet_maps(ref_cell):
    """Per local facet: (origin, tangent matrix (tdim, fdim), ref outward
    normal (tdim,))."""
    fdim = ref_cell.dim - 1
    maps = []
    bary = ref_cell.vertices.mean(axis=0)
    for fverts in ref_cell.facets:
        v0 = ref_cell.vertices[fverts[0]]
        T = np.stack([ref_cell.vertices[fverts[i + 1]] - v0
                      for i in range(fdim)], axis=1)   # (tdim, fdim)
        # outward normal: orthogonal to tangents, pointing away from bary
        if ref_cell.dim == 2:
            t = T[:, 0]
            n = np.array([t[1], -t[0]])
        else:
            n = np.cross(T[:, 0], T[:, 1])
        n = n / np.linalg.norm(n)
        mid = v0 + T.sum(axis=1) / (fdim + 1)
        if np.dot(n, mid - bary) < 0:
            n = -n
        maps.append((v0, T, n))
    return maps


class FacetForm:
    """Assembler for ∫_Γ ... ds over a set of exterior facets.

    residual_fn(x, u, gu, c, gc, n, consts) -> {field: a0}
      contributions are ∫ a0 · v ds for each test field (no grad(v) terms —
      sufficient for every reference ds integral); written against torch
      like VolumeForm's pointwise functions.
    Coefficients: quadrature arrays of shape (nfacets, nq, ...) or scalars.
    jacobian_fn: optional modified-Jacobian residual (the reference's
      regularized-Jacobian pattern, fracture_dolfinx.py:132-138): its
      derivative defines the element matrices and matrix-free actions while
      residual_fn defines F — e.g. an eps-mass term keeping the latent
      block's diagonal bounded away from zero for iterative solvers.
    dtype, device: of every tensor the form makes.
    """

    def __init__(self, space: MixedSpace, facets: np.ndarray,
                 residual_fn: Callable, quadrature_degree: int,
                 dtype: torch.dtype = torch.float64,
                 jacobian_fn: Optional[Callable] = None, device="cuda"):
        self.space = space
        self.residual_fn = residual_fn
        self.jacobian_fn = jacobian_fn
        self.dtype = dtype
        self.device = torch.device(device)
        mesh = space.mesh
        self.mesh = mesh
        ref = mesh.ref_cell
        self.facets = np.asarray(facets, dtype=np.int64)
        fq, fw = cell_quadrature(ref.facet_cell, quadrature_degree)
        self.nq = len(fw)

        cells = mesh.facet_cells[self.facets, 0]
        locals_ = mesh.facet_local_index[self.facets, 0]
        fmaps = _facet_maps(ref)
        geo_el = lagrange_element(mesh.cell_type, mesh.geom_degree)
        coords = mesh.points[mesh.cells]    # (ncells, ngeo, gdim)

        nfac = len(self.facets)
        gdim, tdim = mesh.gdim, mesh.tdim
        xq = np.zeros((nfac, self.nq, gdim))
        wdet = np.zeros((nfac, self.nq))
        normals = np.zeros((nfac, self.nq, gdim))
        # per-field basis tables at facet quadrature, per facet
        field_tab = {f: np.zeros((nfac, self.nq,
                                  space.spaces[f].element.ndof))
                     for f in space.names}
        field_gtab = {f: np.zeros((nfac, self.nq,
                                   space.spaces[f].element.ndof, gdim))
                      for f in space.names}

        for lf in range(ref.num_facets):
            sel = np.flatnonzero(locals_ == lf)
            if len(sel) == 0:
                continue
            v0, T, nref = fmaps[lf]
            cell_pts = v0[None, :] + fq @ T.T        # (nq, tdim)
            gphi, gdphi = geo_el.tabulate(cell_pts)
            cc = coords[cells[sel]]                  # (n, ngeo, gdim)
            xq[sel] = np.einsum("qn,cnd->cqd", gphi, cc)
            J = np.einsum("qnt,cnd->cqdt", gdphi, cc)  # (n, nq, gdim, tdim)
            # facet tangents in physical space
            Jf = np.einsum("cqdt,tf->cqdf", J, T)      # (n, nq, gdim, fdim)
            Gram = np.einsum("cqdf,cqdg->cqfg", Jf, Jf)
            wdet[sel] = fw[None, :] * np.sqrt(np.abs(np.linalg.det(Gram)))
            # outward normal: J^{-T} nref normalized (gdim == tdim case)
            if gdim == tdim:
                Jinv = np.linalg.inv(J)
                nn = np.einsum("cqtd,t->cqd", Jinv, nref)
                nn /= np.linalg.norm(nn, axis=-1, keepdims=True)
                normals[sel] = nn
            for f in space.names:
                el = space.spaces[f].element
                phi, dphi = el.tabulate(cell_pts)
                field_tab[f][sel] = phi[None, :, :]
                if gdim == tdim:
                    GT = np.swapaxes(np.linalg.inv(J), -1, -2)
                else:
                    JTJ = np.einsum("cqdt,cqds->cqts", J, J)
                    GT = np.einsum("cqdt,cqts->cqds", J, np.linalg.inv(JTJ))
                field_gtab[f][sel] = np.einsum(
                    "cqdt,qit->cqid", GT, dphi)

        self._gather_host: Dict[str, np.ndarray] = {}
        for f in space.names:
            fs = space.spaces[f]
            m = fs.value_size
            dm = fs.dofmap[cells].astype(np.int64)
            self._gather_host[f] = (space.offsets[f] + dm[:, :, None] * m
                                    + np.arange(m)[None, None, :])

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self.facet_data = {
            "xq": t(xq),
            "wdet": t(wdet),
            "normals": t(normals),
            "tab": {f: t(v) for f, v in field_tab.items()},
            "gtab": {f: t(v) for f, v in field_gtab.items()},
            "gather_idx": {f: torch.as_tensor(v, device=self.device)
                           for f, v in self._gather_host.items()},
        }
        self.field_m = {f: space.spaces[f].value_size for f in space.names}

    def _as(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ core

    def _fields(self, x, coeffs, data):
        """Field values (n, q, m) and gradients (n, q, m, gdim) at the
        facet quadrature points, and the coefficients as (n, q, ...)."""
        vals, grads = {}, {}
        for f in self.space.names:
            zc = x[data["gather_idx"][f]]            # (n, i, m)
            vals[f] = torch.einsum("nqi,nim->nqm", data["tab"][f], zc)
            grads[f] = torch.einsum("nqid,nim->nqmd", data["gtab"][f], zc)
        cv = {}
        for name, arr in (coeffs or {}).items():
            a = self._as(arr)
            if a.ndim == 2:
                a = a[:, :, None]
            cv[name] = a
        return vals, grads, cv

    def _point_call(self, cnames, consts, fn):
        """call(xq, field values, field gradients, coefficient values,
        normal) at one point -> fn's output, the user's shapes in."""
        names = self.space.names

        def call(xq, svs, sgs, cvs, nrm):
            u = {f: (v[0] if self.field_m[f] == 1 else v)
                 for f, v in zip(names, svs)}
            gu = {f: (g[0] if self.field_m[f] == 1 else g)
                  for f, g in zip(names, sgs)}
            c = {k: (v[0] if tuple(v.shape) == (1,) else v)
                 for k, v in zip(cnames, cvs)}
            return fn(xq, u, gu, c, {}, nrm, consts)
        return call

    def _canon(self, out):
        """User output {f: a0} -> tuple of a0_f (m,) in space order."""
        res = []
        for f, m in self.field_m.items():
            a0 = out.get(f)
            res.append(torch.zeros((m,), dtype=self.dtype, device=self.device)
                       if a0 is None else self._as(a0).reshape(m))
        return tuple(res)

    def _flat_args(self, data, vals, grads, cv):
        """The (facets, points) axes flattened: xq, [values], [gradients],
        coefficient names, [coefficient values], normals."""
        n, q = data["wdet"].shape
        flat = lambda a: a.reshape((n * q,) + tuple(a.shape[2:]))
        names = self.space.names
        cnames = list(cv)
        return (flat(data["xq"]), [flat(vals[f]) for f in names],
                [flat(grads[f]) for f in names], cnames,
                [flat(cv[k]) for k in cnames], flat(data["normals"]))

    def _residual_core(self, x, coeffs, consts, data=None, out_size=None,
                       fn: Optional[Callable] = None):
        data = self.facet_data if data is None else data
        x = self._as(x)
        n, q = data["wdet"].shape
        nf = len(self.space.names)
        vals, grads, cv = self._fields(x, coeffs, data)
        xq, svs, sgs, cnames, cvs, nrm = self._flat_args(data, vals, grads,
                                                          cv)
        call = self._point_call(cnames, consts, fn or self.residual_fn)
        nc = len(cnames)

        def pw(xp, np_, *rest):
            return self._canon(call(xp, rest[:nf], rest[nf:2 * nf],
                                    rest[2 * nf:2 * nf + nc], np_))

        t = vmap(pw)(xq, nrm, *svs, *sgs, *cvs)
        F = torch.zeros(out_size or self.space.num_dofs, dtype=self.dtype,
                        device=self.device)
        for i, f in enumerate(self.space.names):
            a0 = t[i].reshape(n, q, -1) * data["wdet"][:, :, None]
            r = torch.einsum("nqi,nqm->nim", data["tab"][f], a0)
            F = F.index_add(0, data["gather_idx"][f].reshape(-1),
                            r.reshape(-1))
        return F

    def residual(self, x, coeffs=None, consts=None) -> torch.Tensor:
        return self._residual_core(x, coeffs or {}, consts or {})

    def _jacobian_residual_core(self, x, coeffs, consts, data=None,
                                out_size=None):
        """Residual whose derivative defines the Jacobian (differs from
        the true residual when jacobian_fn is set)."""
        return self._residual_core(x, coeffs, consts, data, out_size,
                                   fn=self.jacobian_fn)

    # ------------------------------------------------- element matrices

    def _element_matrices_core(self, x, coeffs, consts, data=None):
        """Facet element matrices (nfacets, L, L), L = sum_f nl_f * m_f —
        jacfwd of the pointwise facet residual (value + gradient coupling
        of a0 terms)."""
        data = self.facet_data if data is None else data
        x = self._as(x)
        n, q = data["wdet"].shape
        names = self.space.names
        nf = len(names)
        vals, grads, cv = self._fields(x, coeffs, data)
        xq, svs, sgs, cnames, cvs, nrm = self._flat_args(data, vals, grads,
                                                          cv)
        call = self._point_call(cnames, consts,
                                self.jacobian_fn or self.residual_fn)

        def pw_jac(xp, np_, *rest):
            cvq = rest[2 * nf:]

            def g(*s):
                return self._canon(call(xp, s[:nf], s[nf:], cvq, np_))
            return jacfwd(g, argnums=tuple(range(2 * nf)))(*rest[:2 * nf])

        J = vmap(pw_jac)(xq, nrm, *svs, *sgs, *cvs)
        unflat = lambda a: a.reshape((n, q) + tuple(a.shape[1:]))
        w = data["wdet"]
        rows = []
        for i, f in enumerate(names):
            tf = data["tab"][f]
            row = []
            for j, g in enumerate(names):
                tg, gg = data["tab"][g], data["gtab"][g]
                K00 = unflat(J[i][j]) * w[:, :, None, None]
                K01 = unflat(J[i][nf + j]) * w[:, :, None, None, None]
                t1 = torch.einsum("nqi,nqab,nqj->niajb", tf, K00, tg)
                t2 = torch.einsum("nqi,nqabd,nqjd->niajb", tf, K01, gg)
                A = t1 + t2
                ne, nlf, mf, nlg, mg = A.shape
                row.append(A.reshape(ne, nlf * mf, nlg * mg))
            rows.append(torch.cat(row, dim=2))
        return torch.cat(rows, dim=1)

    def element_matrices(self, x, coeffs=None, consts=None) -> torch.Tensor:
        return self._element_matrices_core(x, coeffs or {}, consts or {})

    @cached_property
    def local_indices(self) -> np.ndarray:
        """(nfacets, L) global dof for each local mixed slot."""
        per = [self._gather_host[f].reshape(len(self.facets), -1)
               for f in self.space.names]
        return np.concatenate(per, axis=1)

    def make_functional(self, fn: Callable) -> Callable:
        """∫_Γ fn(x, u, gu, c, gc, n, consts) ds (boundary observables,
        e.g. the Signorini penetration integral signorini_dolfinx.py:309-314)."""
        nf = len(self.space.names)

        def functional(x, coeffs=None, consts=None):
            data = self.facet_data
            vals, grads, cv = self._fields(self._as(x), coeffs or {}, data)
            xq, svs, sgs, cnames, cvs, nrm = self._flat_args(data, vals,
                                                              grads, cv)
            call = self._point_call(cnames, consts or {}, fn)
            nc = len(cnames)

            def pw(xp, np_, *rest):
                return self._as(call(xp, rest[:nf], rest[nf:2 * nf],
                                     rest[2 * nf:2 * nf + nc], np_))

            vq = vmap(pw)(xq, nrm, *svs, *sgs, *cvs)
            return torch.sum(vq.reshape(data["wdet"].shape) * data["wdet"])

        return functional
