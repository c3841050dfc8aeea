"""Trace spaces: fields living only on a set of boundary facets.

The replacement for the reference's boundary-submesh latent
space (`create_submesh` + `ufl.MixedFunctionSpace` across meshes with
entity_maps, signorini_dolfinx.py:207-225): instead of building a separate
codim-1 mesh, the trace field's dofs are the facet-closure dofs of a
volume space restricted to the given facets, renumbered contiguously. The
facet assembler gathers through this renumbering; volume basis functions
outside the facet closure vanish identically on the facet (Lagrange), so
the clamped (-1 -> 0) gather slots contribute exactly zero.

Plain numpy: a copy of the reference package's spaces/trace.py, held to
it bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .space import FunctionSpace


@dataclass
class TraceSpace:
    """Scalar/vector Lagrange field restricted to `facets` of the parent
    mesh. Duck-types the FunctionSpace interface the facet assembler and
    MixedSpace need (element, value_size, dofmap, num_dofs)."""

    parent: FunctionSpace
    facets: np.ndarray

    @cached_property
    def _maps(self):
        vol_dofs = self.parent.facet_closure_dofs(self.facets)
        # facet_closure_dofs returns component-expanded ids for vector
        # spaces; trace numbering is over scalar dofs
        m = self.parent.value_size
        scalar = np.unique(vol_dofs // m) if m > 1 else np.asarray(vol_dofs)
        vol2sub = -np.ones(self.parent.num_scalar_dofs, dtype=np.int64)
        vol2sub[scalar] = np.arange(len(scalar))
        return scalar.astype(np.int64), vol2sub

    @property
    def sub_to_parent(self) -> np.ndarray:
        """(n_sub,) parent scalar dof of each trace dof."""
        return self._maps[0]

    @property
    def element(self):
        return self.parent.element

    @property
    def mesh(self):
        return self.parent.mesh

    @property
    def value_size(self) -> int:
        return self.parent.value_size

    @cached_property
    def dofmap(self) -> np.ndarray:
        """(ncells, ndof_local) trace dofs; -1 clamped to 0 for local dofs
        outside the trace closure (their basis vanishes on the facets)."""
        _, vol2sub = self._maps
        dm = vol2sub[self.parent.dofmap.astype(np.int64)]
        return np.maximum(dm, 0).astype(np.int32)

    @property
    def num_scalar_dofs(self) -> int:
        return len(self.sub_to_parent)

    @property
    def num_dofs(self) -> int:
        return self.num_scalar_dofs * self.value_size

    @property
    def dof_points(self) -> np.ndarray:
        return self.parent.dof_points[self.sub_to_parent]

    def interpolate(self, fn) -> np.ndarray:
        vals = np.asarray(fn(self.dof_points.T))
        if self.value_size == 1:
            return vals.reshape(self.num_scalar_dofs).astype(np.float64)
        return vals.T.reshape(-1).astype(np.float64)
