"""Function spaces over meshes.

Replaces `dolfinx.fem.functionspace` + `basix.ufl.mixed_element` (reference
obstacle_pg.py:68-70). A `FunctionSpace` is a scalar/vector Lagrange space
with an entity-numbered dofmap; a `MixedSpace` is an ordered set of named
fields with block (field-contiguous) layout in one flat dof vector — block
layout suits the LVPP saddle-point solvers (block preconditioners operate on
contiguous slices).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..elements.lagrange import LagrangeElement, lagrange_element
from ..mesh.mesh import Mesh
from .dofmap import build_dofmap


@dataclass
class FunctionSpace:
    """Scalar or blocked-vector Lagrange space on a mesh.

    value_size > 1 means a vector field with interleaved component layout:
    global component-dof = scalar_dof * value_size + component.
    """

    mesh: Mesh
    element: LagrangeElement
    value_size: int = 1

    @classmethod
    def create(cls, mesh: Mesh, degree: int, value_size: int = 1,
               variant: str = "equispaced",
               discontinuous: bool = False) -> "FunctionSpace":
        el = lagrange_element(mesh.cell_type, degree, variant, discontinuous)
        return cls(mesh, el, value_size)

    @cached_property
    def _dofmap_data(self) -> Tuple[np.ndarray, int]:
        return build_dofmap(self.mesh, self.element)

    @property
    def dofmap(self) -> np.ndarray:
        """(ncells, ndof_local) scalar dofmap."""
        return self._dofmap_data[0]

    @property
    def num_scalar_dofs(self) -> int:
        return self._dofmap_data[1]

    @property
    def num_dofs(self) -> int:
        return self.num_scalar_dofs * self.value_size

    @cached_property
    def dof_points(self) -> np.ndarray:
        """(num_scalar_dofs, gdim) physical coordinates of each scalar dof
        (valid for point-evaluation/Lagrange dofs)."""
        mesh, el = self.mesh, self.element
        # geometry basis evaluated at the element's reference nodal points
        geo_el = lagrange_element(mesh.cell_type, mesh.geom_degree)
        phi, _ = geo_el.tabulate(el.points)      # (ndof_el, ngeo)
        cell_coords = mesh.points[mesh.cells]    # (ncells, ngeo, gdim)
        x = np.einsum("ng,cgd->cnd", phi, cell_coords)  # (ncells, ndof_el, gdim)
        pts = np.zeros((self.num_scalar_dofs, mesh.gdim))
        pts[self.dofmap.reshape(-1)] = x.reshape(-1, mesh.gdim)
        return pts

    # -------------------------------------------------------- interpolation

    def interpolate(self, fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """Interpolate `fn(x)` (x of shape (gdim, npts), dolfinx convention)
        into the space; returns the flat dof vector (num_dofs,)."""
        vals = np.asarray(fn(self.dof_points.T))
        if self.value_size == 1:
            out = vals.reshape(self.num_scalar_dofs)
            return out.astype(np.float64)
        # vals shape (value_size, npts) -> interleave
        assert vals.shape == (self.value_size, self.num_scalar_dofs), vals.shape
        return vals.T.reshape(-1).astype(np.float64)

    # ---------------------------------------------------------------- BCs

    def facet_closure_dofs(self, facets: np.ndarray,
                           components: Optional[Sequence[int]] = None
                           ) -> np.ndarray:
        """Component-expanded dofs on the closure of the given facets
        (reference: fem.locate_dofs_topological, obstacle_pg.py:79)."""
        mesh = self.mesh
        fc = mesh.facet_cells[facets, 0]
        fl = mesh.facet_local_index[facets, 0]
        dofs: List[np.ndarray] = []
        for lf in range(mesh.ref_cell.num_facets):
            sel = fl == lf
            if not np.any(sel):
                continue
            local = np.array(self.element.facet_dofs(lf), dtype=np.int64)
            dofs.append(self.dofmap[fc[sel]][:, local].reshape(-1))
        sdofs = np.unique(np.concatenate(dofs)) if dofs else np.zeros(0, np.int64)
        if self.value_size == 1:
            return sdofs.astype(np.int32)
        comps = np.arange(self.value_size) if components is None \
            else np.asarray(components)
        return (sdofs[:, None] * self.value_size
                + comps[None, :]).reshape(-1).astype(np.int32)

    def boundary_dofs(self, marker: Optional[Callable] = None,
                      components: Optional[Sequence[int]] = None) -> np.ndarray:
        # degree-1 fast path: vertex dofs are numbered BY vertex id
        # (dofmap.py), so on structured meshes that carry a closed-form
        # boundary hint the whole facet sort-dedup is skipped
        if (marker is None and self.element.degree == 1
                and not self.element.discontinuous
                and getattr(self.mesh, "_boundary_vertices_hint", None)
                is not None):
            sdofs = self.mesh.boundary_vertices().astype(np.int64)
            if self.value_size == 1:
                return sdofs.astype(np.int32)
            comps = (np.arange(self.value_size) if components is None
                     else np.asarray(components))
            return (sdofs[:, None] * self.value_size
                    + comps[None, :]).reshape(-1).astype(np.int32)
        facets = (self.mesh.exterior_facets if marker is None
                  else self.mesh.locate_entities_boundary(marker))
        return self.facet_closure_dofs(facets, components)


@dataclass(frozen=True)
class DirichletBC:
    """Dirichlet condition on a field of a mixed space: field-local
    component-expanded dof indices and their prescribed values."""

    field: str
    dofs: np.ndarray     # (n,) int32, indices within the field's block
    values: np.ndarray   # (n,) float64

    @classmethod
    def from_marker(cls, field: str, space: FunctionSpace,
                    value: float | Callable = 0.0,
                    marker: Optional[Callable] = None,
                    components: Optional[Sequence[int]] = None) -> "DirichletBC":
        dofs = space.boundary_dofs(marker, components)
        if callable(value):
            # evaluate at dof points (scalar-dof points, per component)
            pts = space.dof_points[dofs // max(space.value_size, 1)] \
                if space.value_size > 1 else space.dof_points[dofs]
            vals = np.asarray(value(pts.T)).reshape(-1)
        else:
            vals = np.full(len(dofs), float(value))
        return cls(field, dofs.astype(np.int32), vals.astype(np.float64))


class MixedSpace:
    """Ordered, named collection of function spaces with block dof layout.

    The LVPP problems are all mixed `(u, psi)`-type systems (SURVEY.md §2);
    fields are stored contiguously: [field0 dofs | field1 dofs | ...].
    """

    def __init__(self, fields: Sequence[Tuple[str, FunctionSpace]]):
        self.names: List[str] = [n for n, _ in fields]
        self.spaces: Dict[str, FunctionSpace] = dict(fields)
        sizes = [self.spaces[n].num_dofs for n in self.names]
        self.offsets: Dict[str, int] = {}
        off = 0
        for n, s in zip(self.names, sizes):
            self.offsets[n] = off
            off += s
        self.num_dofs = off

    @property
    def mesh(self) -> Mesh:
        return self.spaces[self.names[0]].mesh

    def slice_of(self, name: str) -> slice:
        off = self.offsets[name]
        return slice(off, off + self.spaces[name].num_dofs)

    def zeros(self) -> np.ndarray:
        return np.zeros(self.num_dofs, dtype=np.float64)

    def split(self, x) -> Dict[str, "np.ndarray"]:
        return {n: x[self.slice_of(n)] for n in self.names}

    def combine(self, parts: Dict[str, "np.ndarray"]):
        import numpy as _np
        return _np.concatenate([_np.asarray(parts[n]) for n in self.names])

    def global_bc_arrays(self, bcs: Sequence[DirichletBC]
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenate BCs into global (dofs, values) arrays."""
        idx, vals = [], []
        for bc in bcs:
            idx.append(bc.dofs.astype(np.int64) + self.offsets[bc.field])
            vals.append(bc.values)
        if not idx:
            return np.zeros(0, np.int32), np.zeros(0)
        return (np.concatenate(idx).astype(np.int32), np.concatenate(vals))
