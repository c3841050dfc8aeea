"""Whole-solve fused MG-PCG: the f32 inner Krylov solve of the mixed
`pc="mg"` Newton step, as a hand-written CUDA kernel (csrc/mgfused.cu)
with its plain PyTorch version beside it.

Contract (that of the reference's whole-solve kernel: ops/mg.pcg's
algorithm on the Jacobi-scaled Schur operator):

    matvec   S p = alpha_s * B * K5(B * p) + C * p
    precond  z = sqf * V(sqf * r),   sqf = B * (4*alpha_s + w0)
    V        = V(1,1) cycle, damped-Jacobi smoothing (omega 0.8),
               full-weighting restriction / bilinear prolongation (exact
               transposes), 24 coarsest-level sweeps

on unpadded (m, m) f32 grids with a zero Dirichlet exterior. B is zero at
pinned and boundary dofs, so sqf = 0 there and the Krylov space is
confined to the free dofs exactly. whier[l] is the level-l diagonal
(w_{l+1} = 4 * FW(w_l), built by the caller with ops/mg.restrict).

The solve runs in chunks of `chunk` iterations. Inside a chunk every
iteration is masked by the loop condition computed on the device (a dead
iteration is the identity); the host reads it once per chunk and decides
whether to go on. Stall exit: best residual within STALL_GUARD of the
stop threshold and no improvement for STALL_WINDOW iterations. A zero
right-hand side returns x = 0 after 0 iterations.

`solve` dispatches on the device of its tensors: a CPU tensor takes
`fused_mg_pcg_reference`, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _nvcc
from .mg import _levels_for, k5_apply, vcycle

OMEGA = 0.8
COARSE_SWEEPS = 24
STALL_WINDOW = 16
STALL_GUARD = 1e4
_TINY = float(np.finfo(np.float32).tiny)

# slots of the kernel's device state vector (csrc/mgfused.cu SC_*)
_SC_IT, _SC_LIVE, _SC_LEN = 0, 7, 16
_TPB = 256

_lib_handle = None


def _check_grid(name: str, t: torch.Tensor, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(b, B, C, whier) -> Tuple[int, List[int]]:
    if b.dim() != 2 or b.shape[0] != b.shape[1]:
        raise ValueError(f"b must be an (m, m) grid, got {tuple(b.shape)}")
    m = int(b.shape[0])
    ms = _levels_for(m)
    if len(whier) != len(ms):
        raise ValueError(f"whier needs {len(ms)} levels for m={m}, "
                         f"got {len(whier)}")
    for name, t in (("b", b), ("B", B), ("C", C)):
        _check_grid(name, t, (m, m), b.device)
    for l, (w, ml) in enumerate(zip(whier, ms)):
        _check_grid(f"whier[{l}]", w, (ml, ml), b.device)
    return m, ms


def _f32(v) -> float:
    """A python float holding the f32 rounding of v."""
    return float(np.float32(v))


# ------------------------------------------------------ plain version

def _alpha(alpha_s: float, dev) -> torch.Tensor:
    return torch.tensor(_f32(alpha_s), dtype=torch.float32, device=dev)


def _matvec(B, C, alpha):
    """p -> S p = alpha * B * K5(B * p) + C * p (alpha a 0-d f32 tensor)."""
    return lambda p: alpha * (B * k5_apply(B * p)) + C * p


def _pc(B, whier: Sequence[torch.Tensor], alpha):
    """r -> z = sqf * V(sqf * r), sqf = B * (4 alpha + w0)."""
    ws = list(whier)
    sqf = B * (4.0 * alpha + ws[0])
    return lambda r: sqf * vcycle(ws, alpha, sqf * r, 1, OMEGA,
                                  COARSE_SWEEPS)


def matvec_reference(p, B, C, alpha_s: float):
    """Plain version of the kernel's matvec S p."""
    return _matvec(B, C, _alpha(alpha_s, p.device))(p)


def pc_reference(r, B, whier: Sequence[torch.Tensor], alpha_s: float):
    """Plain version of one preconditioner application z = sqf V(sqf r)."""
    return _pc(B, whier, _alpha(alpha_s, r.device))(r)


def fused_mg_pcg_reference(b, B, C, whier: Sequence[torch.Tensor],
                           alpha_s: float, tol: float, maxiter: int,
                           chunk: int = 64):
    """Plain PyTorch version of the kernel: same algorithm, same chunked
    control flow. Returns (x (m, m), iterations)."""
    _check_inputs(b, B, C, whier)
    dev, f32 = b.device, torch.float32

    def scalar(v):
        return torch.tensor(v, dtype=f32, device=dev)

    alpha = _alpha(alpha_s, dev)
    tol_t = scalar(_f32(tol))
    matvec, pc = _matvec(B, C, alpha), _pc(B, whier, alpha)

    x = torch.zeros_like(b)
    r = b.clone()
    xb = torch.zeros_like(b)
    it, ib, ok = scalar(0.0), scalar(0.0), scalar(1.0)
    # priming: p = z0 = pc(b), rr = b.b, rz = b.z0
    p = pc(r)
    rr = torch.sum(r * r)
    rz = torch.sum(r * p)
    stop = tol_t * tol_t * rr
    rrb = rr
    guard_stop = STALL_GUARD * stop

    def live_of(it, ib, rrb, ok, rr):
        stalled = (it - ib > STALL_WINDOW) & (rrb < guard_stop)
        return (ok > 0.5) & ~stalled & (it < maxiter) & (rr > stop)

    while bool(live_of(it, ib, rrb, ok, rr)):      # one read per chunk
        for _ in range(chunk):
            live = live_of(it, ib, rrb, ok, rr)
            Ap = matvec(p)
            pAp = torch.sum(p * Ap)
            good = live & (pAp > _TINY) & (rz > _TINY)
            a = torch.where(good, rz / torch.where(good, pAp, 1.0), 0.0)
            x = torch.where(live, x + a * p, x)
            r = torch.where(live, r - a * Ap, r)
            z = pc(r)
            rz_new = torch.where(live, torch.sum(r * z), rz)
            beta = torch.where(good, rz_new / torch.where(good, rz, 1.0),
                               0.0)
            p = torch.where(live, z + beta * p, p)
            rr = torch.where(live, torch.sum(r * r), rr)
            better = live & (rr < rrb)
            xb = torch.where(better, x, xb)
            rrb = torch.where(better, rr, rrb)
            ib = torch.where(better, it + 1.0, ib)
            ok = torch.where(live, good.to(f32), ok)
            it = torch.where(live, it + 1.0, it)
            rz = rz_new
    return xb, int(it)


# ------------------------------------------------------------- kernel

def build(force: bool = False) -> str:
    """Compile csrc/mgfused.cu into csrc/build/libmgfused.so when the
    library is missing, older than the source, or force is set. Returns
    nvcc's report (registers and shared memory, from -Xptxas -v)."""
    return _nvcc.build("mgfused", force)


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _nvcc.load("mgfused")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mgf_scratch_floats.restype = ctypes.c_longlong
        lib.mgf_scratch_floats.argtypes = [I]
        lib.mgf_error_string.restype = ctypes.c_char_p
        lib.mgf_error_string.argtypes = [I]
        lib.mgf_chunk.restype = I
        lib.mgf_chunk.argtypes = [P] * 9 + [I, I, I] + [F] * 5 + [P]
        lib.mgf_matvec.restype = I
        lib.mgf_matvec.argtypes = [P] * 5 + [F, I, P]
        lib.mgf_restrict.restype = I
        lib.mgf_restrict.argtypes = [P, P, I, P]
        lib.mgf_prolong_add.restype = I
        lib.mgf_prolong_add.argtypes = [P, P, I, P]
        lib.mgf_pc.restype = I
        lib.mgf_pc.argtypes = [P] * 5 + [F, I, P]
        _lib_handle = lib
    return _lib_handle


def _raise_on(err: int, what: str):
    if err != 0:
        msg = _lib().mgf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _scratch(lib, m: int, dev) -> torch.Tensor:
    return torch.empty(int(lib.mgf_scratch_floats(m)), dtype=torch.float32,
                       device=dev)


def _kernel_solve(b, B, C, whier, alpha_s, tol, maxiter, chunk):
    lib = _lib()
    m, _ = _check_inputs(b, B, C, whier)
    dev = b.device
    wflat = torch.cat([w.reshape(-1) for w in whier])
    x = torch.zeros_like(b)
    r = b.clone()
    p = torch.zeros_like(b)
    xb = torch.zeros_like(b)
    scratch = _scratch(lib, m, dev)
    sc = torch.zeros(_SC_LEN, dtype=torch.float32, device=dev)
    stream = _nvcc.stream_of(b)
    first = 1
    while True:
        err = lib.mgf_chunk(
            B.data_ptr(), C.data_ptr(), wflat.data_ptr(), x.data_ptr(),
            r.data_ptr(), p.data_ptr(), xb.data_ptr(), scratch.data_ptr(),
            sc.data_ptr(), m, chunk, first, _f32(alpha_s), _f32(tol),
            float(maxiter), float(STALL_WINDOW), STALL_GUARD, stream)
        _raise_on(err, "mgf_chunk")
        solve.launches += 1
        first = 0
        # the one host read of the chunk: iterations and the loop condition
        it, live = sc[[_SC_IT, _SC_LIVE]].tolist()
        if live < 0.5:
            return xb, int(it)


def solve(b, B, C, whier: Sequence[torch.Tensor], alpha_s: float,
          tol: float, maxiter: int, chunk: int = 64):
    """Fused MG-PCG solve of S x = b on (m, m) f32 grids; returns
    (x (m, m), iterations). CPU tensors take the plain version; CUDA
    tensors launch the kernel (solve.launches counts kernel chunks)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if b.device.type == "cpu":
        return fused_mg_pcg_reference(b, B, C, whier, alpha_s, tol,
                                      maxiter, chunk)
    _nvcc.require_cuda(b)
    return _kernel_solve(b, B, C, whier, alpha_s, tol, maxiter, chunk)


solve.launches = 0


# --------------------------------------- kernel pieces, for comparison

def kernel_matvec(p, B, C, alpha_s: float):
    """The kernel's S p, launched alone."""
    _nvcc.require_cuda(p, B, C)
    lib, m = _lib(), int(p.shape[0])
    for name, t in (("p", p), ("B", B), ("C", C)):
        _check_grid(name, t, (m, m), p.device)
    Ap = torch.empty_like(p)
    part = torch.empty(-(-m * m // _TPB), dtype=torch.float32,
                       device=p.device)
    _raise_on(lib.mgf_matvec(B.data_ptr(), C.data_ptr(), p.data_ptr(),
                             Ap.data_ptr(), part.data_ptr(), _f32(alpha_s),
                             m, _nvcc.stream_of(p)), "mgf_matvec")
    return Ap


def kernel_restrict(f):
    """The kernel's full-weighting restriction, launched alone."""
    _nvcc.require_cuda(f)
    lib, m = _lib(), int(f.shape[0])
    _check_grid("f", f, (m, m), f.device)
    if m < 3 or m % 2 == 0:
        raise ValueError(f"restriction needs an odd m >= 3, got {m}")
    mc = (m - 1) // 2 + 1
    c = torch.empty((mc, mc), dtype=torch.float32, device=f.device)
    _raise_on(lib.mgf_restrict(f.data_ptr(), c.data_ptr(), m,
                               _nvcc.stream_of(f)), "mgf_restrict")
    return c


def kernel_prolong_add(e, x):
    """x += P e on the fine grid, in place; returns x."""
    _nvcc.require_cuda(e, x)
    mc = int(e.shape[0])
    if mc < 2:
        raise ValueError(f"prolongation needs a coarse m >= 2, got {mc}")
    _check_grid("e", e, (mc, mc), e.device)
    _check_grid("x", x, (2 * mc - 1, 2 * mc - 1), e.device)
    _raise_on(_lib().mgf_prolong_add(e.data_ptr(), x.data_ptr(),
                                     int(e.shape[0]), _nvcc.stream_of(e)),
              "mgf_prolong_add")
    return x


def kernel_pc(r, B, whier: Sequence[torch.Tensor], alpha_s: float):
    """One preconditioner application z = sqf * V(sqf * r) by the
    kernel's V-cycle."""
    _nvcc.require_cuda(r, B)
    lib = _lib()
    m, _ = _check_inputs(r, B, B, whier)
    wflat = torch.cat([w.reshape(-1) for w in whier])
    z = torch.empty_like(r)
    scratch = _scratch(lib, m, r.device)
    _raise_on(lib.mgf_pc(B.data_ptr(), wflat.data_ptr(), r.data_ptr(),
                         z.data_ptr(), scratch.data_ptr(), _f32(alpha_s), m,
                         _nvcc.stream_of(r)), "mgf_pc")
    return z
