"""DIA sparse matrix-vector product: a hand-written CUDA kernel
(csrc/dia.cu k_spmv, the counterpart of the reference's
ops/pallas_spmv.py) with its plain PyTorch version beside it.

    y[i] = sum_d data[d, i] * x[i + off[d]]   (zero outside [0, N))

summed in offsets order, one rounding per product and per add; the
kernel (built with -fmad=false) gives the same bits.

`dia_spmv` dispatches on the device of its tensors: a CPU tensor takes
`dia_spmv_reference`, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _nvcc
from ._nvcc import require_cuda, stream_of

MAX_DIAGS = 64       # csrc/dia.cu MAX_DIAGS, la/dia.py host_build's limit

_lib_handle = None


def dia_spmv_reference(offsets: Sequence[int], data: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version: one shifted-slice multiply-add per diagonal."""
    y = torch.zeros_like(x)
    n = x.shape[0]
    for i, off in enumerate(offsets):
        if off == 0:
            y += data[i] * x
        elif off > 0:
            # x[i + off] for i < n - off; zero tail
            y[:n - off] += data[i, :n - off] * x[off:]
        else:
            k = -off
            y[k:] += data[i, k:] * x[:n - k]
    return y


def check_operator(offsets: Sequence[int], data: torch.Tensor,
                   n: int, device, dtype) -> Tuple[int, ...]:
    """Validate a DIA operator of n rows for a kernel call; returns the
    offsets as a tuple of ints."""
    offs = tuple(int(o) for o in offsets)
    if not 1 <= len(offs) <= MAX_DIAGS:
        raise ValueError(f"need 1..{MAX_DIAGS} diagonals, got {len(offs)}")
    if data.dtype != dtype:
        raise TypeError(f"data must be {dtype}, got {data.dtype}")
    if tuple(data.shape) != (len(offs), n):
        raise ValueError(f"data must have shape {(len(offs), n)}, "
                         f"got {tuple(data.shape)}")
    if data.device != device:
        raise ValueError(f"data is on {data.device}, expected {device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    return offs


def check_vector(name: str, t: torch.Tensor, n: int, device, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name} must have shape ({n},), "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_dtype(t: torch.Tensor):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"float32 or float64 needed, got {t.dtype}")


# ------------------------------------------------------------- kernel

def lib() -> ctypes.CDLL:
    """The built csrc/dia.cu, shared with ops/dia_cg.py."""
    global _lib_handle
    if _lib_handle is None:
        h = _nvcc.load("dia")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        h.dia_error_string.restype = ctypes.c_char_p
        h.dia_error_string.argtypes = [I]
        for suf in ("f32", "f64"):
            fn = getattr(h, f"dia_spmv_{suf}")
            fn.restype, fn.argtypes = I, [P, P, I, P, P, L, P]
        # the DIA-CG workspace and its chunk graphs (ops/dia_cg.py)
        for name, res, args in (
                ("dcg_ws_create", P,
                 [I, L, L, L, I, P, P, I, P, P, I, I, P, P, P, P, P, P]),
                ("dcg_ws_info", None, [P, P, P]),
                ("dcg_ws_destroy", None, [P]),
                ("dcg_capture", P, [P, I, I, P]),
                ("dcg_launch", I, [P, P]),
                ("dcg_graph_destroy", None, [P]),
                ("dcg_k1", I, [P, P]),
                ("dcg_k2", I, [P, P])):
            fn = getattr(h, name)
            fn.restype, fn.argtypes = res, args
        _lib_handle = h
    return _lib_handle


def build(force: bool = False) -> str:
    """Compile csrc/dia.cu into csrc/build/libdia.so (see mgfused.build)."""
    return _nvcc.build("dia", force)


def suffix(t: torch.Tensor) -> str:
    return "f32" if t.dtype == torch.float32 else "f64"


def offsets_arg(offs: Tuple[int, ...]):
    """The offsets as a C int array (the caller keeps it alive)."""
    return (ctypes.c_int * len(offs))(*offs)


def raise_on(err: int, what: str):
    if err != 0:
        msg = lib().dia_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dia_spmv(offsets: Sequence[int], data: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A x for the DIA matrix (offsets, data (ndiags, N)) and x (N,),
    f32 or f64. CPU tensors take the plain version; CUDA tensors launch
    the kernel (dia_spmv.launches counts the launches)."""
    check_dtype(x)
    if x.dim() != 1:
        raise ValueError(f"x must be a vector, got shape {tuple(x.shape)}")
    n = int(x.shape[0])
    check_vector("x", x, n, x.device, x.dtype)
    offs = check_operator(offsets, data, n, x.device, x.dtype)
    if x.device.type == "cpu":
        return dia_spmv_reference(offs, data, x)
    require_cuda(x)
    y = torch.empty_like(x)
    c_offs = offsets_arg(offs)
    err = getattr(lib(), f"dia_spmv_{suffix(x)}")(
        data.data_ptr(), c_offs, len(offs), x.data_ptr(), y.data_ptr(), n,
        stream_of(x))
    raise_on(err, "dia_spmv")
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0
