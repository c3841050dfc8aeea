"""Block-Thomas forward and back substitution: a hand-written CUDA kernel
(csrc/btapply.cu k_bt_apply) beside its plain PyTorch version
(la/blocktri.py bt_apply_reference).

    z_{k-1} = Minv_{k-1} y_{k-1},   y_k = b_k - L_{k-1} z_{k-1}   (y_0 = b_0)
    x_{nb-1} = Minv_{nb-1} y_{nb-1},  x_k = z_k - T_k x_{k+1}

for every leading batch axis at once: the apply of the dense block-Thomas
factor (la/blocktri.py bt_factor) in the btlu directions and in the
Schwarz preconditioner asm_btlu (parallel/dofpart.py). It replaces no TPU
kernel. One launch an apply: a thread-block cluster a system, its blocks
each a slab of rows, the vector passed between them in distributed
shared memory; the sums run in a fixed order, so two launches give the
same bits. They agree with the plain version to rounding.

`bt_apply` dispatches on the device of its tensors: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from ._nvcc import require_cuda, stream_of

VEC_SMEM_MAX = 32768   # csrc/btapply.cu: the most vector bytes in shared
MAX_CLUSTER = 16       # csrc/btapply.cu: blocks of a system's cluster
_INT_MAX = 2**31 - 1

_lib_handle = None


def check_inputs(Minv: torch.Tensor, T: torch.Tensor, L: torch.Tensor,
                 b_blocks: torch.Tensor):
    """Validate a call of bt_apply; returns (S, nb, bs), S the product of
    the leading batch axes."""
    if b_blocks.dim() < 2:
        raise ValueError(f"b_blocks must be (..., nb, bs), got shape "
                         f"{tuple(b_blocks.shape)}")
    lead = tuple(b_blocks.shape[:-2])
    nb, bs = (int(d) for d in b_blocks.shape[-2:])
    if nb < 1 or bs < 1:
        raise ValueError(f"nb and bs must be at least 1, got {nb} and {bs}")
    want = {"Minv": lead + (nb, bs, bs), "T": lead + (nb - 1, bs, bs),
            "L": lead + (nb - 1, bs, bs)}
    for name, t in (("Minv", Minv), ("T", T), ("L", L)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got "
                             f"{tuple(t.shape)}")
    if b_blocks.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"b_blocks must be float32 or float64, got "
                        f"{b_blocks.dtype}")
    for name, t in (("Minv", Minv), ("T", T), ("L", L)):
        if t.dtype != b_blocks.dtype:
            raise TypeError(f"{name} is {t.dtype}, b_blocks "
                            f"{b_blocks.dtype}")
        if t.device != b_blocks.device:
            raise ValueError(f"{name} is on {t.device}, b_blocks on "
                             f"{b_blocks.device}")
    for name, t in (("Minv", Minv), ("T", T), ("L", L),
                    ("b_blocks", b_blocks)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    S = b_blocks.numel() // (nb * bs)
    if S * MAX_CLUSTER > _INT_MAX or 3 * nb > _INT_MAX:
        raise ValueError(f"sizes past int32: S {S}, nb {nb}")
    return S, nb, bs


# ------------------------------------------------------------- kernel

def lib() -> ctypes.CDLL:
    """The built csrc/btapply.cu."""
    global _lib_handle
    if _lib_handle is None:
        h = _nvcc.load("btapply")
        P, I = ctypes.c_void_p, ctypes.c_int
        h.bt_error_string.restype = ctypes.c_char_p
        h.bt_error_string.argtypes = [I]
        for fn in (h.bt_apply_f64, h.bt_apply_f32):
            fn.restype = I
            fn.argtypes = [P, P, P, P, P, P, I, I, I, P]
        h.bt_apply_plan.restype = I
        h.bt_apply_plan.argtypes = [I, I, I, I, ctypes.POINTER(I)]
        _lib_handle = h
    return _lib_handle


def build(force: bool = False) -> str:
    """Compile csrc/btapply.cu into csrc/build/libbtapply.so (see
    _nvcc.build)."""
    return _nvcc.build("btapply", force)


def _raise_on(err: int, what: str):
    if err != 0:
        msg = lib().bt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


PLAN_KEYS = ("cluster", "rows_a_group", "groups", "cols_a_tile",
             "col_tiles", "ring_slots", "slot_bytes", "vec_global",
             "smem_bytes", "waves", "fast")


def plan(S: int, nb: int, bs: int, dtype: torch.dtype,
         device: torch.device) -> dict:
    """The kernel's launch geometry for S systems (nb, bs) of `dtype` on
    `device` (csrc/btapply.cu bt_apply_plan)."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    isz = 8 if dtype == torch.float64 else 4
    with torch.cuda.device(device):
        _raise_on(lib().bt_apply_plan(S, nb, bs, isz, out), "bt_apply plan")
    return dict(zip(PLAN_KEYS, out))


def bt_apply(Minv: torch.Tensor, T: torch.Tensor, L: torch.Tensor,
             b_blocks: torch.Tensor) -> torch.Tensor:
    """x (..., nb, bs): the block-Thomas apply of the factor Minv (...,
    nb, bs, bs), T and L (..., nb - 1, bs, bs) to b_blocks (..., nb, bs),
    all contiguous, of one dtype (f32 or f64). CPU tensors take the plain
    version (la/blocktri.bt_apply_reference); CUDA tensors launch the
    kernel (bt_apply.launches counts the launches) on PyTorch's current
    stream."""
    S, nb, bs = check_inputs(Minv, T, L, b_blocks)
    if b_blocks.device.type == "cpu":
        from ..la.blocktri import bt_apply_reference
        return bt_apply_reference(Minv, T, L, b_blocks)
    require_cuda(b_blocks)
    x = torch.empty_like(b_blocks)
    f64 = b_blocks.dtype == torch.float64
    isz = 8 if f64 else 4
    vg = None
    if bs * isz > VEC_SMEM_MAX:
        vg = torch.empty((max(S, 1), 2, bs), dtype=b_blocks.dtype,
                         device=b_blocks.device)
    fn = lib().bt_apply_f64 if f64 else lib().bt_apply_f32
    with torch.cuda.device(b_blocks.device):
        err = fn(Minv.data_ptr(), T.data_ptr(), L.data_ptr(),
                 b_blocks.data_ptr(), x.data_ptr(),
                 None if vg is None else vg.data_ptr(), S, nb, bs,
                 stream_of(b_blocks))
    _raise_on(err, "bt_apply")
    bt_apply.launches += 1
    return x


bt_apply.launches = 0
