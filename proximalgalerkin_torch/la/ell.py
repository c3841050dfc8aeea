"""Device-resident ELL sparse matrices.

The replacement for PETSc's assembled AIJ matrices: fixed-width padded
rows (ELLPACK) so SpMV is a dense gather + multiply + row-reduce. The
pattern is built on the host (numpy, native sort-dedup, disk cache);
values and SpMV live in torch tensors on the solve device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class EllPattern:
    """Host-precomputed sparsity data for a fixed mesh/space/BC set.

    csr slot layout: unique (row, col) pairs sorted lexicographically.
      slot_map:   (e*L*L,) csr slot of each element-matrix entry
      keep:       (nnz,) 0.0 where the entry is zeroed by BC rows/cols
      diag_ones:  (nnz,) 1.0 at bc-row diagonal slots (added post-zeroing)
      ell_gather: (N, K) csr slot feeding each ELL lane (nnz slot -> lane),
                  padded with slot nnz (a synthetic zero entry)
      ell_cols:   (N, K) column ids, padded with the row itself
    """

    num_dofs: int
    nnz: int
    width: int
    slot_map: np.ndarray
    keep: np.ndarray
    diag_ones: np.ndarray
    ell_gather: np.ndarray
    ell_cols: np.ndarray

    @classmethod
    def build(cls, local_indices: np.ndarray, num_dofs: int,
              bc_idx: Optional[np.ndarray] = None) -> "EllPattern":
        # Content-addressed disk cache: the sort-dedup over e*L*L entries
        # costs minutes of host time at protocol sizes (measured: ~110 s
        # for the 50^2 multiphase pattern, 13M entries, on the 1-core
        # bench host) and is identical across every run/probe/record of
        # the same problem. Keyed on the full input bytes, so stale hits
        # are impossible.
        import hashlib
        from pathlib import Path
        gi = np.asarray(local_indices, dtype=np.int64)
        bc_arr = (np.asarray(bc_idx, dtype=np.int64)
                  if bc_idx is not None else np.empty(0, np.int64))
        h = hashlib.sha256()
        h.update(gi.tobytes())
        h.update(np.int64(num_dofs).tobytes())
        h.update(bc_arr.tobytes())
        cache = Path(__file__).resolve().parents[2] / ".pattern_cache"
        f = cache / f"ell_{h.hexdigest()[:24]}.npz"
        if f.exists():
            try:
                z = np.load(f)
                return cls(num_dofs=int(z["num_dofs"]), nnz=int(z["nnz"]),
                           width=int(z["width"]), slot_map=z["slot_map"],
                           keep=z["keep"], diag_ones=z["diag_ones"],
                           ell_gather=z["ell_gather"], ell_cols=z["ell_cols"])
            except Exception:
                pass
        pat = cls._build_uncached(gi, num_dofs, bc_arr)
        try:
            cache.mkdir(exist_ok=True)
            tmp = f.with_suffix(".tmp.npz")
            np.savez(tmp, num_dofs=pat.num_dofs, nnz=pat.nnz,
                     width=pat.width, slot_map=pat.slot_map, keep=pat.keep,
                     diag_ones=pat.diag_ones, ell_gather=pat.ell_gather,
                     ell_cols=pat.ell_cols)
            tmp.replace(f)
        except Exception:
            pass
        return pat

    @classmethod
    def _build_uncached(cls, gi: np.ndarray, num_dofs: int,
                        bc_idx: np.ndarray) -> "EllPattern":
        from ..native import unique_with_inverse
        E, L = gi.shape
        rows = np.repeat(gi, L, axis=1).reshape(-1)
        cols = np.tile(gi, (1, L)).reshape(-1)
        key = rows * num_dofs + cols
        # native C++ sort-dedup (numpy fallback inside) — the setup hot
        # spot at 1M+ dofs
        uniq, slot = unique_with_inverse(key)
        nnz = len(uniq)
        urow = (uniq // num_dofs).astype(np.int64)
        ucol = (uniq % num_dofs).astype(np.int64)

        bc = np.zeros(num_dofs, dtype=bool)
        if bc_idx is not None and len(bc_idx):
            bc[np.asarray(bc_idx, dtype=np.int64)] = True
        keep = (~(bc[urow] | bc[ucol])).astype(np.float64)
        diag_ones = ((urow == ucol) & bc[urow]).astype(np.float64)

        counts = np.bincount(urow, minlength=num_dofs)
        K = int(counts.max()) if nnz else 1
        # lane index of each csr slot within its row (slots are row-sorted)
        row_start = np.zeros(num_dofs + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        lane = np.arange(nnz) - row_start[urow]

        ell_gather = np.full((num_dofs, K), nnz, dtype=np.int64)
        ell_cols = np.tile(np.arange(num_dofs, dtype=np.int64)[:, None], (1, K))
        ell_gather[urow, lane] = np.arange(nnz)
        ell_cols[urow, lane] = ucol

        return cls(num_dofs=num_dofs, nnz=nnz, width=K,
                   slot_map=slot.astype(np.int32),
                   keep=keep, diag_ones=diag_ones,
                   ell_gather=ell_gather.astype(np.int32),
                   ell_cols=ell_cols.astype(np.int32))


class EllMatrix:
    """Pattern + device index arrays; assemble(element_matrices) -> ELL
    data, spmv(data, x) -> gather + row sum."""

    def __init__(self, pattern: EllPattern, dtype: torch.dtype,
                 device: torch.device):
        self.pattern = pattern
        self.dtype = dtype
        self.device = torch.device(device)
        self._arrays = None

    @property
    def arrays(self):
        """Device index/mask arrays, moved LAZILY on first use — the DIA
        path never touches them, and they are hundreds of MB at 1M+ dofs."""
        if self._arrays is None:
            p, dev = self.pattern, self.device
            self._arrays = {
                "slot_map": torch.as_tensor(p.slot_map.astype(np.int64),
                                            device=dev),
                "keep": torch.as_tensor(p.keep, dtype=self.dtype, device=dev),
                "diag_ones": torch.as_tensor(p.diag_ones, dtype=self.dtype,
                                             device=dev),
                "ell_gather": torch.as_tensor(
                    p.ell_gather.astype(np.int64), device=dev),
                "ell_cols": torch.as_tensor(p.ell_cols.astype(np.int64),
                                            device=dev),
            }
        return self._arrays

    def assemble(self, element_matrices: torch.Tensor) -> torch.Tensor:
        """(e, L, L) element matrices -> (N, K) ELL data with BCs applied
        (zeroed bc rows/cols, unit bc diagonal — the reference's
        assemble_matrix(J, a, bcs) semantics, problem.py:75-77)."""
        a = self.arrays
        flat = element_matrices.reshape(-1).to(self.dtype)
        csr = torch.zeros(self.pattern.nnz + 1, dtype=self.dtype,
                          device=self.device)
        csr[:-1].index_add_(0, a["slot_map"], flat)
        csr[:-1] = csr[:-1] * a["keep"] + a["diag_ones"]
        return csr[a["ell_gather"]]

    def spmv(self, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(data * x[self.arrays["ell_cols"]], dim=1)

    def diagonal(self, data: torch.Tensor) -> torch.Tensor:
        row = torch.arange(self.pattern.num_dofs, device=self.device)[:, None]
        mask = self.arrays["ell_cols"] == row
        return torch.sum(torch.where(mask, data, torch.zeros_like(data)),
                         dim=1)
