"""DIA (diagonal) sparse storage.

For matrices whose nonzeros live on a small set of diagonals (structured
meshes, or any mesh after a bandwidth-reducing dof ordering) SpMV is a
handful of shifted multiply-adds: no gathers (ops/dia_spmv.py).

y[i] = sum_d data[d, i] * x[i + off[d]]   (zero outside [0, N))
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.dia_spmv import dia_spmv


@dataclass
class DiaMatrix:
    """offsets: python ints; data packed (ndiags, N) on the solve device."""

    offsets: Tuple[int, ...]
    data: torch.Tensor           # (ndiags, N)
    n: int

    @classmethod
    def host_build(cls, rows: np.ndarray, cols: np.ndarray,
                   vals: np.ndarray, n: int, max_diags: int = 64
                   ) -> Optional[Tuple[Tuple[int, ...], np.ndarray]]:
        """Pure-host DIA packing: (offsets, data (ndiags, n) numpy) or None
        if the pattern needs more than max_diags distinct diagonals."""
        deltas = cols.astype(np.int64) - rows.astype(np.int64)
        offs = np.unique(deltas)
        if len(offs) > max_diags:
            return None
        data = np.zeros((len(offs), n))
        d_idx = np.searchsorted(offs, deltas)
        # accumulate duplicates (COO semantics) — fancy-index assignment is
        # last-write-wins and silently dropped repeated entries (e.g. ELL
        # (row,row,0) padding zeroing the stored diagonal)
        np.add.at(data, (d_idx, rows), vals)
        return tuple(int(o) for o in offs), data

    def spmv(self, x: torch.Tensor, data: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """y = A x (ops/dia_spmv: the CUDA kernel on a CUDA tensor, the
        shifted-slice plain version on the CPU)."""
        return dia_spmv(self.offsets, self.data if data is None else data, x)

    def diagonal(self, data: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = self.data if data is None else data
        return d[self.offsets.index(0)]
