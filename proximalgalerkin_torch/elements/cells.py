"""Reference cell definitions.

Topology conventions follow Basix/DOLFINx (the reference's element library):
  - interval:  vertices (0,), (1,)
  - triangle:  vertices (0,0),(1,0),(0,1); edges (1,2),(0,2),(0,1)
  - quadrilateral: vertices (0,0),(1,0),(0,1),(1,1); edges (0,1),(0,2),(1,3),(2,3)
  - tetrahedron: vertices e_0..e_3; edges (2,3),(1,3),(1,2),(0,3),(0,2),(0,1);
    facets (1,2,3),(0,2,3),(0,1,3),(0,1,2)
  - hexahedron: lexicographic vertices; 12 edges, 6 quad facets

These orderings drive dofmap construction (shared-entity dof identification
and edge/face orientation) in spaces/dofmap.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class ReferenceCell:
    name: str
    dim: int
    vertices: np.ndarray                      # (n_verts, dim)
    edges: Tuple[Tuple[int, ...], ...]        # vertex ids per edge
    facets: Tuple[Tuple[int, ...], ...]       # vertex ids per codim-1 facet
    facet_cell: str                           # cell type of a facet
    is_simplex: bool
    volume: float

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    @property
    def num_facets(self) -> int:
        return len(self.facets)


_point = ReferenceCell(
    name="point", dim=0, vertices=np.zeros((1, 0)), edges=(), facets=(),
    facet_cell="", is_simplex=True, volume=1.0,
)

_interval = ReferenceCell(
    name="interval", dim=1,
    vertices=np.array([[0.0], [1.0]]),
    edges=((0, 1),),
    facets=((0,), (1,)),
    facet_cell="point", is_simplex=True, volume=1.0,
)

_triangle = ReferenceCell(
    name="triangle", dim=2,
    vertices=np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    edges=((1, 2), (0, 2), (0, 1)),
    facets=((1, 2), (0, 2), (0, 1)),
    facet_cell="interval", is_simplex=True, volume=0.5,
)

_quadrilateral = ReferenceCell(
    name="quadrilateral", dim=2,
    vertices=np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
    edges=((0, 1), (0, 2), (1, 3), (2, 3)),
    facets=((0, 1), (0, 2), (1, 3), (2, 3)),
    facet_cell="interval", is_simplex=False, volume=1.0,
)

_tetrahedron = ReferenceCell(
    name="tetrahedron", dim=3,
    vertices=np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                       [0.0, 0.0, 1.0]]),
    edges=((2, 3), (1, 3), (1, 2), (0, 3), (0, 2), (0, 1)),
    facets=((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)),
    facet_cell="triangle", is_simplex=True, volume=1.0 / 6.0,
)

_hexahedron = ReferenceCell(
    name="hexahedron", dim=3,
    vertices=np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.], [1., 1., 0.],
                       [0., 0., 1.], [1., 0., 1.], [0., 1., 1.], [1., 1., 1.]]),
    edges=((0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
           (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)),
    facets=((0, 1, 2, 3), (0, 1, 4, 5), (0, 2, 4, 6),
            (1, 3, 5, 7), (2, 3, 6, 7), (4, 5, 6, 7)),
    facet_cell="quadrilateral", is_simplex=False, volume=1.0,
)

_CELLS = {c.name: c for c in
          (_point, _interval, _triangle, _quadrilateral, _tetrahedron, _hexahedron)}


def reference_cell(name: str) -> ReferenceCell:
    try:
        return _CELLS[name]
    except KeyError:
        raise ValueError(f"unknown cell type {name!r}; known: {sorted(_CELLS)}")
