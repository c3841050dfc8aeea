"""Dofmap construction (host-side numpy, at setup).

Replaces DOLFINx's C++ dofmap builder. Dofs are numbered entity-blocked
(vertex dofs, then edge-interior, then facet-interior, then cell-interior);
edge-interior dof sequences are reversed when a cell traverses a global edge
against its canonical (sorted-vertex) orientation, which makes Lagrange
point-evaluation dofs match across neighboring cells for any degree.
"""

from __future__ import annotations

import numpy as np

from ..elements.lagrange import LagrangeElement
from ..mesh.mesh import Mesh


def build_dofmap(mesh: Mesh, element: LagrangeElement):
    """Returns (dofmap (ncells, ndof_local) int32, num_dofs).

    For discontinuous elements each cell receives its own block of dofs.
    """
    ncells = mesh.num_cells
    nd = element.ndof

    if element.discontinuous:
        dm = np.arange(ncells * nd, dtype=np.int32).reshape(ncells, nd)
        return dm, ncells * nd

    ref = element.cell
    d = ref.dim
    ed = element.entity_dofs
    n_vert = len(ed[0][0]) if ref.num_vertices else 0
    n_edge = len(ed[1][0]) if d >= 1 and len(ed[1]) else 0
    n_facet = len(ed[2][0]) if d == 3 and len(ed) > 2 and len(ed[2]) else 0
    n_int = len(ed[d][0]) if len(ed[d]) else 0
    if d == 2:
        # in 2D, entity dim 2 is the cell interior; facets are the edges
        n_facet = 0
        n_int = len(ed[2][0]) if len(ed[2]) else 0

    cv = mesh.cell_vertices
    nverts = int(cv.max()) + 1 if ncells else 0

    dm = np.zeros((ncells, nd), dtype=np.int64)

    offset = 0
    # --- vertex dofs
    if n_vert:
        assert n_vert == 1, "Lagrange has one dof per vertex"
        for lv in range(ref.num_vertices):
            (slot,) = ed[0][lv]
            dm[:, slot] = offset + cv[:, lv]
        offset += nverts * n_vert

    # --- edge-interior dofs (with orientation)
    if d >= 1 and n_edge:
        edge_verts, cell_edges = mesh.edges
        nedges = edge_verts.shape[0]
        for le, (la, lb) in enumerate(ref.edges):
            slots = np.array(ed[1][le], dtype=np.int64)
            g = cell_edges[:, le].astype(np.int64)
            # canonical orientation: global edge runs lo -> hi vertex id
            flipped = cv[:, la] > cv[:, lb]
            base = offset + g * n_edge
            seq = np.arange(n_edge, dtype=np.int64)
            fwd = base[:, None] + seq[None, :]
            rev = base[:, None] + seq[::-1][None, :]
            dm[:, slots] = np.where(flipped[:, None], rev, fwd)
        offset += nedges * n_edge

    # --- facet-interior dofs (3D)
    if d == 3 and n_facet:
        if n_facet > 1:
            raise NotImplementedError(
                "3D facet-interior dof orientation for >1 dof per facet "
                "(degree >= 3 on tets / >= 4 on hexes) not yet implemented")
        facet_local = mesh.facet_local_index
        facet_cells = mesh.facet_cells
        nfacets = facet_cells.shape[0]
        # invert: (cell, local_facet) -> global facet
        cell_facets = -np.ones((ncells, ref.num_facets), dtype=np.int64)
        for col in range(2):
            c, lf = facet_cells[:, col], facet_local[:, col]
            keep = c >= 0
            cell_facets[c[keep], lf[keep]] = np.arange(nfacets)[keep]
        for lf in range(ref.num_facets):
            slots = np.array(ed[2][lf], dtype=np.int64)
            g = cell_facets[:, lf]
            dm[:, slots] = offset + g[:, None] * n_facet + np.arange(n_facet)[None, :]
        offset += nfacets * n_facet

    # --- cell-interior dofs
    if n_int:
        slots = np.array(ed[d][0], dtype=np.int64)
        dm[:, slots] = (offset + np.arange(ncells, dtype=np.int64)[:, None] * n_int
                        + np.arange(n_int)[None, :])
        offset += ncells * n_int

    return dm.astype(np.int32), int(offset)
