"""ctypes bindings for the native host-setup kernels (pattern.cpp).

Auto-builds the shared object with `make` on first import if a compiler
is available; every caller has a pure-numpy fallback, so absence of a
toolchain only costs setup speed.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_SO = _DIR / "libpgtorch_native.so"
_lib = None


_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed:
        return None
    src = _DIR / "pattern.cpp"
    stale = (not _SO.exists()
             or (src.exists() and src.stat().st_mtime > _SO.stat().st_mtime))
    if stale:
        try:
            subprocess.run(["make", "-B", "-C", str(_DIR)],
                           capture_output=True, timeout=120, check=True)
        except Exception:
            _failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        _failed = True
        return None
    lib.build_pattern.restype = ctypes.c_int64
    lib.build_pattern.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.scatter_add.restype = None
    lib.scatter_add.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    # correctness smoke test against numpy — a wrong/foreign binary must
    # route every caller to the numpy fallback, not corrupt setup data
    try:
        keys = np.array([5, 1, 5, 3, 1, 1], dtype=np.int64)
        uniq = np.empty(len(keys), dtype=np.int64)
        slot = np.empty(len(keys), dtype=np.int64)
        nu = lib.build_pattern(keys.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)), len(keys),
            uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            slot.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        ref_u, ref_i = np.unique(keys, return_inverse=True)
        if nu != len(ref_u) or not np.array_equal(uniq[:nu], ref_u) \
                or not np.array_equal(slot, ref_i):
            raise ValueError("build_pattern self-test mismatch")
    except Exception:
        _failed = True
        return None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pf64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def unique_with_inverse(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted unique keys + inverse slot map — np.unique(return_inverse)
    via the native sort path, with numpy fallback."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _load()
    if lib is None:
        uniq, inv = np.unique(keys, return_inverse=True)
        return uniq.astype(np.int64), inv.astype(np.int64)
    n = len(keys)
    uniq = np.empty(n, dtype=np.int64)
    slot = np.empty(n, dtype=np.int64)
    nuniq = lib.build_pattern(_p64(keys), n, _p64(uniq), _p64(slot))
    return uniq[:nuniq].copy(), slot


def scatter_add(vals: np.ndarray, slots: np.ndarray, size: int) -> np.ndarray:
    """out[slots] += vals with out zeros(size) — np.add.at replacement."""
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    out = np.zeros(size, dtype=np.float64)
    lib = _load()
    if lib is None:
        np.add.at(out, slots, vals)
        return out
    lib.scatter_add(_pf64(vals), _p64(slots), len(vals), _pf64(out))
    return out
