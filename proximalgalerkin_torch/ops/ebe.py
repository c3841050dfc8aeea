"""Element-by-element product with element matrices: a hand-written CUDA
kernel (csrc/ebe.cu k_ebe_apply) with its plain PyTorch version beside
it.

    y[gidx[c, i]] += sum_j A[c, i, j] * x[gidx[c, j]],   y of out_size

The Jacobian action of the distributed Newton from the element matrices
its Schwarz factor already holds (parallel/dofpart.py); it replaces no
TPU kernel. The kernel adds each row's sum with an atomic, in an order
that changes from launch to launch, so it agrees with the plain version
to rounding, not bit for bit.

`ebe_apply` dispatches on the device of its tensors: a CPU tensor takes
`ebe_apply_reference`, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from ._nvcc import require_cuda, stream_of

MAX_L = 32           # csrc/ebe.cu MAX_L: local slots of an element
_INT_MAX = 2**31 - 1

_lib_handle = None


def ebe_apply_reference(A: torch.Tensor, gidx: torch.Tensor, x: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """Plain version: a batched A @ x[gidx], then one index_add."""
    g = gidx.long()
    rows = (A @ x[g].unsqueeze(-1)).squeeze(-1)
    return torch.zeros(out_size, dtype=x.dtype, device=x.device).index_add_(
        0, g.reshape(-1), rows.reshape(-1))


def check_inputs(A: torch.Tensor, gidx: torch.Tensor, x: torch.Tensor,
                 out_size: int):
    """Validate a call of ebe_apply; returns (ne, L). The indices
    themselves are the caller's to keep inside x and out_size."""
    if A.dtype != torch.float64 or x.dtype != torch.float64:
        raise TypeError(f"A and x must be float64, got {A.dtype} and "
                        f"{x.dtype}")
    if gidx.dtype != torch.int32:
        raise TypeError(f"gidx must be int32, got {gidx.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must have shape (ne, L, L), got "
                         f"{tuple(A.shape)}")
    ne, L = int(A.shape[0]), int(A.shape[1])
    if not 1 <= L <= MAX_L:
        raise ValueError(f"L must be 1..{MAX_L}, got {L}")
    if tuple(gidx.shape) != (ne, L):
        raise ValueError(f"gidx must have shape {(ne, L)}, got "
                         f"{tuple(gidx.shape)}")
    if x.dim() != 1:
        raise ValueError(f"x must be a vector, got shape {tuple(x.shape)}")
    if ne * L > _INT_MAX or not 1 <= out_size <= _INT_MAX \
            or x.shape[0] > _INT_MAX:
        raise ValueError(f"sizes past int32: ne * L = {ne * L}, out_size "
                         f"{out_size}, len(x) {x.shape[0]}")
    for name, t in (("A", A), ("gidx", gidx)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("A", A), ("gidx", gidx), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return ne, L


# ------------------------------------------------------------- kernel

def lib() -> ctypes.CDLL:
    """The built csrc/ebe.cu."""
    global _lib_handle
    if _lib_handle is None:
        h = _nvcc.load("ebe")
        P, I = ctypes.c_void_p, ctypes.c_int
        h.ebe_error_string.restype = ctypes.c_char_p
        h.ebe_error_string.argtypes = [I]
        h.ebe_apply_f64.restype = I
        h.ebe_apply_f64.argtypes = [P, P, P, P, I, I, P]
        _lib_handle = h
    return _lib_handle


def build(force: bool = False) -> str:
    """Compile csrc/ebe.cu into csrc/build/libebe.so (see _nvcc.build)."""
    return _nvcc.build("ebe", force)


def ebe_apply(A: torch.Tensor, gidx: torch.Tensor, x: torch.Tensor,
              out_size: int) -> torch.Tensor:
    """y (out_size,) = the element-by-element product of A (ne, L, L)
    with x gathered and scattered through gidx (ne, L), f64 with int32
    indices. CPU tensors take the plain version; CUDA tensors launch the
    kernel (ebe_apply.launches counts the launches)."""
    ne, L = check_inputs(A, gidx, x, out_size)
    if x.device.type == "cpu":
        return ebe_apply_reference(A, gidx, x, out_size)
    require_cuda(x)
    y = torch.zeros(out_size, dtype=x.dtype, device=x.device)
    err = lib().ebe_apply_f64(A.data_ptr(), gidx.data_ptr(), x.data_ptr(),
                              y.data_ptr(), ne, L, stream_of(x))
    if err != 0:
        msg = lib().ebe_error_string(err).decode()
        raise RuntimeError(f"ebe_apply: CUDA error {err} ({msg})")
    ebe_apply.launches += 1
    return y


ebe_apply.launches = 0
