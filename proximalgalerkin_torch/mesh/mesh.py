"""SoA unstructured mesh.

The rebuild's replacement for `dolfinx.mesh.Mesh`: plain numpy arrays
(points, cell connectivity) computed on host at setup, shipped to device as
needed by the assembly layer. Geometry may be higher-order (isoparametric)
for curved/manifold domains (the eikonal Möbius strip runs on cubic-geometry
quads, reference examples/09_eikonal/convert_mesh.cpp:15-56).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..elements.cells import ReferenceCell, reference_cell


@dataclass
class Mesh:
    cell_type: str
    points: np.ndarray          # (npoints, gdim) geometry node coordinates
    cells: np.ndarray           # (ncells, nodes_per_cell) geometry node ids
    geom_degree: int = 1
    cell_tags: Optional[np.ndarray] = None   # (ncells,) int markers
    facet_tags: Optional[Dict[int, int]] = None  # facet index -> marker

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64)
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)

    # ------------------------------------------------------------ basic

    @property
    def ref_cell(self) -> ReferenceCell:
        return reference_cell(self.cell_type)

    @property
    def tdim(self) -> int:
        return self.ref_cell.dim

    @property
    def gdim(self) -> int:
        return self.points.shape[1]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return int(self.cell_vertices.max()) + 1 if self.num_cells else 0

    @cached_property
    def cell_vertices(self) -> np.ndarray:
        """(ncells, nverts) vertex ids (the first nodes of each cell for the
        entity-ordered geometry node layout used by our generators)."""
        nv = self.ref_cell.num_vertices
        return self.cells[:, :nv]

    # --------------------------------------------------------- topology

    @cached_property
    def _facet_data(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Unique codim-1 facets.

        Returns (facet_vertices (nfacets, nfv), facet_cells (nfacets, 2),
        facet_local (nfacets, 2)); second column is -1 for boundary facets.
        """
        ref = self.ref_cell
        cv = self.cell_vertices
        local_facets = np.array([list(f) for f in ref.facets], dtype=np.int64)
        nlf, nfv = local_facets.shape
        # all (cell, local_facet) vertex tuples
        fv = cv[:, local_facets]                      # (ncells, nlf, nfv)
        fv_flat = fv.reshape(-1, nfv)
        key = np.sort(fv_flat, axis=1).astype(np.int64)
        nv_total = int(cv.max()) + 2
        if nfv <= 3 and nv_total ** nfv < 2**62:
            # pack sorted vertex tuples into scalar int64 keys: 1D dedup
            # (native sort) is ~10x faster than np.unique(axis=0)
            from ..native import unique_with_inverse
            packed = key[:, 0]
            for j in range(1, nfv):
                packed = packed * nv_total + key[:, j]
            uniq_k, inv = unique_with_inverse(packed)
            nfacets = len(uniq_k)
        else:
            uniq, inv = np.unique(key, axis=0, return_inverse=True)
            nfacets = uniq.shape[0]
        facet_cells = -np.ones((nfacets, 2), dtype=np.int32)
        facet_local = -np.ones((nfacets, 2), dtype=np.int32)
        cell_ids = np.repeat(np.arange(self.num_cells), nlf)
        local_ids = np.tile(np.arange(nlf), self.num_cells)
        order = np.argsort(inv, kind="stable")
        inv_s, cells_s, loc_s = inv[order], cell_ids[order], local_ids[order]
        first = np.ones(len(inv_s), dtype=bool)
        first[1:] = inv_s[1:] != inv_s[:-1]
        facet_cells[inv_s[first], 0] = cells_s[first]
        facet_local[inv_s[first], 0] = loc_s[first]
        second = ~first
        facet_cells[inv_s[second], 1] = cells_s[second]
        facet_local[inv_s[second], 1] = loc_s[second]
        # store un-sorted vertex order from the first cell's perspective
        fverts = fv_flat[order[first]].astype(np.int32)
        # reorder rows to facet index order
        perm = inv_s[first]
        out_v = np.empty_like(fverts)
        out_v[perm] = fverts
        return out_v, facet_cells, facet_local

    @property
    def facet_vertices(self) -> np.ndarray:
        return self._facet_data[0]

    @property
    def facet_cells(self) -> np.ndarray:
        return self._facet_data[1]

    @property
    def facet_local_index(self) -> np.ndarray:
        return self._facet_data[2]

    @property
    def num_facets(self) -> int:
        return self.facet_vertices.shape[0]

    @cached_property
    def exterior_facets(self) -> np.ndarray:
        """Indices of boundary facets (reference: mesh.exterior_facet_indices,
        obstacle_pg.py:77)."""
        return np.flatnonzero(self.facet_cells[:, 1] < 0).astype(np.int32)

    @cached_property
    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """Unique edges: (edge_vertices (nedges, 2), cell_edges (ncells, nle))
        where cell_edges maps each cell's local edge to its global edge id."""
        ref = self.ref_cell
        cv = self.cell_vertices
        local_edges = np.array([list(e) for e in ref.edges], dtype=np.int64)
        ev = cv[:, local_edges]                       # (ncells, nle, 2)
        key = np.sort(ev.reshape(-1, 2), axis=1).astype(np.int64)
        nv_total = int(cv.max()) + 2
        from ..native import unique_with_inverse
        packed = key[:, 0] * nv_total + key[:, 1]
        uniq_k, inv = unique_with_inverse(packed)
        uniq = np.stack([uniq_k // nv_total, uniq_k % nv_total], axis=1)
        return uniq.astype(np.int32), inv.reshape(self.num_cells, -1).astype(np.int32)

    # ------------------------------------------------------------ query

    def midpoints(self, dim: int, entities: np.ndarray) -> np.ndarray:
        if dim == self.tdim:
            return self.points[self.cell_vertices[entities]].mean(axis=1)
        if dim == self.tdim - 1:
            return self.points[self.facet_vertices[entities]].mean(axis=1)
        if dim == 0:
            return self.points[entities]
        raise ValueError(dim)

    def locate_entities_boundary(self, marker: Callable[[np.ndarray], np.ndarray]
                                 ) -> np.ndarray:
        """Boundary facets whose vertices all satisfy `marker(x)` (x has shape
        (gdim, npts) to match the dolfinx marker convention)."""
        ext = self.exterior_facets
        fv = self.facet_vertices[ext]
        ok = marker(self.points.T)      # (npoints,) bool
        keep = np.all(ok[fv], axis=1)
        return ext[keep]

    def boundary_vertices(self) -> np.ndarray:
        # structured generators know their boundary in closed form and set
        # the hint — skips the facet sort-dedup (~6 s at 1024^2)
        hint = getattr(self, "_boundary_vertices_hint", None)
        if hint is not None:
            return hint
        return np.unique(self.facet_vertices[self.exterior_facets])
