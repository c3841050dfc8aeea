"""Dtypes and the flat, PETSc-style options dictionary.

The reference configures every solver through the PETSc options database
(string-keyed flat dicts, e.g. obstacle_pg.py:128-139). The same key names
are kept so that reference example configs translate 1:1; the port's own
Newton/Krylov stack interprets them.

The JAX package turns on x64 globally when it is imported; the port never
changes torch's default dtype. Every tensor it makes gets an explicit
dtype, f64 unless PGTPU_DISABLE_X64=1 (the JAX package's switch).
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch


def default_dtype() -> torch.dtype:
    """Default floating dtype for FEM state (f64 unless x64 disabled)."""
    if os.environ.get("PGTPU_DISABLE_X64", "0") == "1":
        return torch.float32
    return torch.float64


class SolverOptions(dict):
    """Flat string-keyed options dict with PETSc-style names and defaults.

    Examples of keys honored by the solve/ stack:
      snes_rtol, snes_atol, snes_stol, snes_max_it, snes_linesearch_type
      (none|l2|bt), snes_monitor, snes_error_if_not_converged,
      ksp_type (preonly|cg|minres|gmres|gmres_d|bicgstab), ksp_rtol,
      ksp_atol, ksp_max_it, ksp_monitor, pc_type (none|jacobi|lu),
      pc_factor_mat_solver_type (scipy — the host sparse LU standing in
      for MUMPS).
    """

    _DEFAULTS: Mapping[str, Any] = {
        "snes_rtol": 1e-8,
        "snes_atol": 1e-50,
        "snes_stol": 1e-8,
        "snes_max_it": 50,
        "snes_linesearch_type": "none",
        "snes_linesearch_damping": 1.0,
        "snes_error_if_not_converged": False,
        "snes_monitor": False,
        "ksp_type": "preonly",
        "ksp_rtol": 1e-10,
        "ksp_atol": 1e-50,
        "ksp_max_it": 10_000,
        "ksp_error_if_not_converged": False,
        "ksp_monitor": False,
        "pc_type": "lu",
        "pc_factor_mat_solver_type": "scipy",
    }

    def opt(self, key: str, default: Any = None) -> Any:
        if key in self:
            v = self[key]
            # PETSc-style flags pass None to mean "enabled".
            return True if v is None else v
        if default is not None:
            return default
        return self._DEFAULTS.get(key)

    @classmethod
    def with_prefix(cls, options: Mapping[str, Any], prefix: str) -> "SolverOptions":
        """Extract options under a namespacing prefix (PETSc prefixPush model,
        reference src/lvpp/problem.py:97-103)."""
        out = cls()
        for k, v in options.items():
            if k.startswith(prefix):
                out[k[len(prefix):]] = v
            else:
                out.setdefault(k, v)
        return out
