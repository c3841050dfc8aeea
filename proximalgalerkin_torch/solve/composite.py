"""Composite problems: a volume form plus facet forms over a shared block
vector — the mixed-dimensional assembly kind="mpi" block problem of the
reference (signorini_dolfinx.py:283-291), in PyTorch. The port of the
reference package's solve/composite.py.

It satisfies the NewtonSolver problem protocol (device, set_bc, zero_bc,
residual, jacobian_scipy, jacobian_action). As in the reference, it has no
device direction: on one device the Newton step is the host LU direction
(element matrices on the device, SuperLU on the host). The Krylov, btlu and
fused-Newton directions of a composite problem belong to the distributed
Signorini path (parallel/dofpart.DistributedProblem, ROADMAP A12), and
asking this class for a Krylov one raises NotImplementedError.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch.func import jvp

from ..assembly.assemble import VolumeForm
from ..assembly.facets import FacetForm
from ..spaces.space import DirichletBC


class CompositeProblem:
    def __init__(self, space_all, vol_form: VolumeForm,
                 facet_forms: Sequence[FacetForm],
                 bcs: Sequence[DirichletBC] = (),
                 coeffs: Optional[Mapping] = None,
                 consts: Optional[Mapping] = None):
        self.space = space_all
        self.form = vol_form           # dtype carrier for NewtonSolver
        self.vol_form = vol_form
        self.facet_forms = list(facet_forms)
        self.device = vol_form.device
        self.n_vol = vol_form.space.num_dofs
        bc_idx, bc_vals = space_all.global_bc_arrays(list(bcs))
        self._bc_idx_host = np.asarray(bc_idx, dtype=np.int64)
        self.bc_idx = torch.as_tensor(self._bc_idx_host, device=self.device)
        self.bc_vals = vol_form._as(np.asarray(bc_vals))
        self.coeffs = dict(coeffs or {})        # volume-form coefficients
        self.facet_coeffs = {}                   # facet-form coefficients
        self.consts = dict(consts or {})

    def update(self, coeffs=None, consts=None, facet_coeffs=None):
        if coeffs:
            self.coeffs.update(coeffs)
        if facet_coeffs:
            self.facet_coeffs.update(facet_coeffs)
        if consts:
            self.consts.update(consts)

    def set_bc(self, x):
        return self.form._as(x).index_put((self.bc_idx,), self.bc_vals)

    def zero_bc(self, v):
        return v.index_put((self.bc_idx,), v.new_zeros(()))

    def residual(self, x):
        x = self.form._as(x)
        Fv = self.vol_form.residual(x[:self.n_vol], self.coeffs, self.consts)
        F = torch.cat((Fv, Fv.new_zeros(self.space.num_dofs - self.n_vol)))
        for ff in self.facet_forms:
            F = F + ff.residual(x, self.facet_coeffs, self.consts)
        return F.index_put((self.bc_idx,), x[self.bc_idx] - self.bc_vals)

    def jacobian_scipy(self, x, timer=None):
        """Assembled CSR with bc rows/cols zeroed and unit diagonal, as the
        reference builds it: the volume form's assemble_scipy, the facet
        element matrices on the device, the COO sum and the row/column
        zeroing (LIL) on the host. With a PhaseTimer, the device element
        matrices, the copy to the host and the host sparse work are timed
        as 'assembly', 'host_transfer' and 'csr'."""
        import contextlib
        import scipy.sparse as sp
        phase = (timer.phase if timer is not None
                 else lambda name: contextlib.nullcontext())
        N = self.space.num_dofs
        x = self.form._as(x)
        Av = self.vol_form.assemble_scipy(x[:self.n_vol], self.coeffs,
                                          self.consts, timer)
        with phase("assembly"):
            Ae = [ff.element_matrices(x, self.facet_coeffs, self.consts)
                  for ff in self.facet_forms]
        with phase("host_transfer"):
            Ae = [a.cpu().numpy() for a in Ae]
        with phase("csr"):
            Av = Av.tocoo()
            rows, cols, vals = [Av.row], [Av.col], [Av.data]
            for ff, a in zip(self.facet_forms, Ae):
                gi = ff.local_indices
                L = gi.shape[1]
                rows.append(np.repeat(gi, L, axis=1).reshape(-1))
                cols.append(np.tile(gi, (1, L)).reshape(-1))
                vals.append(a.reshape(-1))
            A = sp.coo_matrix((np.concatenate(vals),
                               (np.concatenate(rows), np.concatenate(cols))),
                              shape=(N, N)).tolil()
            idx = self._bc_idx_host
            if len(idx):
                A[idx, :] = 0.0
                A[:, idx] = 0.0
                A[idx, idx] = 1.0
            return A.tocsr()

    def jacobian_diagonal(self, x):
        return self.form._as(self.jacobian_scipy(x).diagonal())

    def jacobian_action(self, x):
        """v -> J(x) v through torch.func.jvp of the volume and facet
        Jacobian residuals, with the symmetric bc treatment."""
        coeffs, consts = self.coeffs, self.consts
        fcoeffs = self.facet_coeffs
        x = self.form._as(x)

        def Av(v):
            w = self.zero_bc(v)
            f_vol = lambda yv: self.vol_form._jacobian_residual_core(
                yv, coeffs, consts)
            yv = jvp(f_vol, (x[:self.n_vol],), (w[:self.n_vol],))[1]
            y = torch.cat((yv, yv.new_zeros(self.space.num_dofs
                                            - self.n_vol)))
            for ff in self.facet_forms:
                f_fac = lambda z, ff=ff: ff._jacobian_residual_core(
                    z, fcoeffs, consts)
                y = y + jvp(f_fac, (x,), (w,))[1]
            y = self.zero_bc(y)
            return y.index_add(0, self.bc_idx, v[self.bc_idx])

        return Av

    def direction_solver(self, *args, **kwargs):
        raise NotImplementedError(
            "a device Krylov direction of a CompositeProblem: the composite "
            "(Signorini) problem solves with the host LU direction "
            "(ksp_type='preonly', pc_type='lu') on one device; its Krylov "
            "direction belongs to the distributed path "
            "(parallel/dofpart.DistributedProblem, ROADMAP A12)")
