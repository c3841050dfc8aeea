"""Manifold meshes (2D cells embedded in 3D).

The eikonal example runs on a Möbius strip (reference: an MFEM-generated
VTU ingested by examples/09_eikonal/read_mobius_dolfinx.py:41-85 after
convert_mesh.cpp). Here the strip is generated directly from its
parametrization, including the half-twist seam identification — no mesh
file round-trip needed. The assembly pipeline handles gdim=3/tdim=2 via
the Gram-determinant surface measure and pseudo-inverse gradient pullback
(assembly/geometry.py).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh


def mobius_strip(ns: int = 48, nt: int = 6, width: float = 0.4,
                 radius: float = 1.0, cell_type: str = "quadrilateral"
                 ) -> Mesh:
    """Möbius strip: x(s,t) = ((R + t cos(s/2)) cos s,
    (R + t cos(s/2)) sin s, t sin(s/2)), s in [0, 2pi), t in [-w/2, w/2],
    with the seam identification (s=2pi, t) ~ (s=0, -t)."""
    hw = width / 2.0
    ts = np.linspace(-hw, hw, nt + 1)
    ss = np.linspace(0.0, 2.0 * np.pi, ns, endpoint=False)

    def vid(i, j):
        # seam: column ns maps back to column 0 with t flipped
        i = np.asarray(i)
        j = np.asarray(j)
        wrapped = i == ns
        jj = np.where(wrapped, nt - j, j)
        ii = np.where(wrapped, 0, i)
        return ii * (nt + 1) + jj

    S, T = np.meshgrid(ss, ts, indexing="ij")
    X = (radius + T * np.cos(S / 2)) * np.cos(S)
    Y = (radius + T * np.cos(S / 2)) * np.sin(S)
    Z = T * np.sin(S / 2)
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    I, J = np.meshgrid(np.arange(ns), np.arange(nt), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00 = vid(I, J)
    v10 = vid(I + 1, J)
    v01 = vid(I, J + 1)
    v11 = vid(I + 1, J + 1)
    if cell_type == "quadrilateral":
        cells = np.stack([v00, v10, v01, v11], axis=1)
        return Mesh("quadrilateral", pts, cells)
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    return Mesh("triangle", pts, np.concatenate([t1, t2], axis=0))
