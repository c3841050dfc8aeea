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

On the card a solve runs in a workspace kept per (device, m): its grids,
its device state vector and the CUDA graphs of its chunks, captured once
per (chunk, first) and replayed by one host call per chunk
(csrc/mgfused.cu). Every solve of one m on one device uses that
workspace, so such solves must not run at once on two streams or
threads. The V-cycle is split as `level_plan` says: one down-leg and one
up-leg grid kernel per level above the tail, then every level from the
first with m <= 65 in one block.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import _nvcc
from .mg import _levels_for, k5_apply, prolong, restrict, vcycle

OMEGA = 0.8
COARSE_SWEEPS = 24
STALL_WINDOW = 16
STALL_GUARD = 1e4
_TINY = float(np.finfo(np.float32).tiny)

# the largest level the one-block tail takes; the tail's levels then fit
# one block's shared memory (at most 92 KB, csrc/mgfused.cu tail_bytes)
_TAIL_MAX = 65

# slots of the kernel's device state vector (csrc/mgfused.cu SC_*)
_SC_IT, _SC_LIVE, _SC_BETA = 0, 7, 10
_SC_ALPHA, _SC_LEN = 16, 32
# workspace slots whose offsets the wrapper reads (csrc/mgfused.cu OFF_*)
_OFF_B, _OFF_C, _OFF_W, _OFF_R0, _OFF_XB, _OFF_Z, _OFF_SC = range(7)

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


def matvec_update_reference(t0, p_old, B, C, w0, alpha_s: float,
                            beta: float):
    """Plain version of the kernel's matvec step: p' = sqf t0 + beta p_old
    (sqf t0 is the preconditioned residual z), returns (p', S p')."""
    alpha = _alpha(alpha_s, t0.device)
    beta_t = _alpha(beta, t0.device)
    pn = B * (4.0 * alpha + w0) * t0 + beta_t * p_old
    return pn, _matvec(B, C, alpha)(pn)


def down_reference(b, w, alpha_s: float):
    """Plain version of the kernel's down leg of a level: the residual of
    the pre-smooth from zero, restricted to the next level."""
    alpha = _alpha(alpha_s, b.device)
    x = OMEGA * b / (alpha * 4.0 + w)
    return restrict(b - (alpha * k5_apply(x) + w * x))


def up_reference(b, w, e, alpha_s: float):
    """Plain version of the kernel's up leg of a level: the post-smooth of
    the pre-smoothed x plus the prolonged coarse correction e."""
    alpha = _alpha(alpha_s, b.device)
    d = alpha * 4.0 + w
    x = OMEGA * b / d + prolong(e)
    return x + OMEGA * (b - (alpha * k5_apply(x) + w * x)) / d


def level_plan(m: int) -> Tuple[List[int], int]:
    """(level sizes, lt): the kernel's split of the V-cycle. Levels
    0 .. lt-1 take one down-leg and one up-leg grid kernel each; levels
    lt .. L-1 run in the one-block tail, which starts at the first level
    with m <= 65 (lt = L: no such level, and the coarsest level is swept
    by grid kernels). The kernel takes lt from here."""
    ms = _levels_for(m)
    return ms, next((l for l, ml in enumerate(ms) if ml <= _TAIL_MAX),
                    len(ms))


def pc_by_plan_reference(r, B, whier: Sequence[torch.Tensor],
                         alpha_s: float):
    """One preconditioner application as the kernel splits it
    (level_plan): down legs, the bottom of the cycle (the tail or the
    coarsest sweeps, both the V-cycle of the remaining levels), up legs.
    The same arithmetic as pc_reference, in the kernel's pieces."""
    ms, lt = level_plan(int(r.shape[0]))
    L = len(ms)
    ws = list(whier)
    alpha = _alpha(alpha_s, r.device)
    sqf = B * (4.0 * alpha + ws[0])
    c = 0 if L == 1 or lt == 0 else min(lt, L - 1)
    bs = [sqf * r]
    for l in range(c):
        bs.append(down_reference(bs[l], ws[l], alpha_s))
    e = vcycle(ws[c:], alpha, bs[c], 1, OMEGA, COARSE_SWEEPS)
    for l in range(c - 1, -1, -1):
        e = up_reference(bs[l], ws[l], e, alpha_s)
    return sqf * e


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
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pI = ctypes.POINTER(ctypes.c_int)
        for name, res, args in (
                ("mgf_error_string", ctypes.c_char_p, [I]),
                ("mgf_ws_floats", LL, [I, I]),
                ("mgf_ws_create", P, [I, I, P, P, pI]),
                ("mgf_ws_offset", LL, [P, I]),
                ("mgf_ws_destroy", None, [P]),
                ("mgf_capture", P, [P, I, I, pI]),
                ("mgf_launch", I, [P, P]),
                ("mgf_graph_destroy", None, [P]),
                ("mgf_pc", I, [P, P]),
                ("mgf_fine_blocks", LL, [I]),
                ("mgf_matvec", I, [P] * 10 + [I, P]),
                ("mgf_down", I, [P] * 4 + [I, P]),
                ("mgf_up", I, [P] * 5 + [I, P])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib_handle = lib
    return _lib_handle


def _raise_on(err: int, what: str, lib=None):
    if err != 0:
        msg = (lib or _lib()).mgf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _graph_key(chunk: int, first: bool) -> Tuple[int, bool]:
    """A chunk's graph depends on its length and on whether it primes."""
    return int(chunk), bool(first)


class _Workspace:
    """The kernel's device buffers for one m (with the tail from level
    lt, level_plan), and the chunk graphs captured over them (one per _graph_key). Every pointer a
    captured kernel sees stays fixed, so a graph serves every solve."""

    def __init__(self, lib, m: int, lt: int, dev):
        nf = int(lib.mgf_ws_floats(m, lt))
        if nf < 0:
            raise ValueError(f"no workspace for m={m} with the tail at "
                             f"level {lt}")
        self.lib, self.m = lib, m
        self.buf = torch.zeros(nf, dtype=torch.float32, device=dev)
        self.cnt = torch.zeros(2, dtype=torch.int32, device=dev)
        err = ctypes.c_int(0)
        handle = lib.mgf_ws_create(m, lt, self.buf.data_ptr(),
                                   self.cnt.data_ptr(), ctypes.byref(err))
        _raise_on(err.value, "mgf_ws_create", lib)
        if not handle:
            raise RuntimeError(f"mgf_ws_create failed for m={m}")
        self.handle = handle
        self.graphs: Dict[Tuple[int, bool], int] = {}

        def view(slot, size):
            off = int(lib.mgf_ws_offset(handle, slot))
            return self.buf[off:off + size]

        n = m * m
        self.B, self.C = view(_OFF_B, n), view(_OFF_C, n)
        self.W = view(_OFF_W, sum(k * k for k in _levels_for(m)))
        self.R0, self.XB = view(_OFF_R0, n), view(_OFF_XB, n)
        self.Z, self.sc = view(_OFF_Z, n), view(_OFF_SC, _SC_LEN)

    def load(self, B, whier, C=None):
        """Copies the operator in (on the caller's stream)."""
        self.B.copy_(B.reshape(-1))
        if C is not None:
            self.C.copy_(C.reshape(-1))
        torch.cat([w.reshape(-1) for w in whier], out=self.W)

    def set_params(self, alpha_s: float, tol: float = 0.0,
                   maxiter: int = 0):
        """alpha, tol, maxiter, the stall window and guard into sc."""
        self.sc[_SC_ALPHA:_SC_ALPHA + 5] = torch.tensor(
            [_f32(alpha_s), _f32(tol), float(maxiter), float(STALL_WINDOW),
             STALL_GUARD], dtype=torch.float32)

    def graph(self, chunk: int, first: bool) -> int:
        """The instantiated graph of a chunk, captured at first use."""
        key = _graph_key(chunk, first)
        if key not in self.graphs:
            err = ctypes.c_int(0)
            g = self.lib.mgf_capture(self.handle, key[0], int(key[1]),
                                     ctypes.byref(err))
            _raise_on(err.value, "mgf_capture", self.lib)
            if not g:
                raise RuntimeError("mgf_capture returned no graph")
            self.graphs[key] = g
        return self.graphs[key]

    def launch(self, chunk: int, first: bool, stream: int):
        _raise_on(self.lib.mgf_launch(self.graph(chunk, first), stream),
                  "mgf_launch", self.lib)

    def close(self):
        """Destroys the graphs and the workspace (after the device is done
        with them)."""
        for g in self.graphs.values():
            self.lib.mgf_graph_destroy(g)
        self.graphs.clear()
        if self.handle:
            self.lib.mgf_ws_destroy(self.handle)
            self.handle = None


_workspaces: Dict[tuple, _Workspace] = {}


def release_workspaces():
    """Frees every cached workspace and its graphs; the next solve builds
    them anew."""
    devices = {key[0] for key in _workspaces}
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    for ws in _workspaces.values():
        ws.close()
    _workspaces.clear()


def _workspace(m: int, dev) -> _Workspace:
    """The workspace of m on dev, made at first use and shared by every
    solve and kernel_pc call there (not reentrant: one at a time)."""
    key = (dev, m)
    if key not in _workspaces:
        _workspaces[key] = _Workspace(_lib(), m, level_plan(m)[1], dev)
    return _workspaces[key]


def _kernel_solve(b, B, C, whier, alpha_s, tol, maxiter, chunk):
    m, _ = _check_inputs(b, B, C, whier)
    ws = _workspace(m, b.device)
    ws.load(B, whier, C)
    ws.R0.copy_(b.reshape(-1))
    ws.set_params(alpha_s, tol, maxiter)
    stream = _nvcc.stream_of(b)
    first = True
    while True:
        ws.launch(chunk, first, stream)
        solve.launches += 1
        first = False
        # the one host read of the chunk: iterations and the loop condition
        it, live = ws.sc[[_SC_IT, _SC_LIVE]].tolist()
        if live < 0.5:
            return ws.XB.clone().view(m, m), int(it)


def solve(b, B, C, whier: Sequence[torch.Tensor], alpha_s: float,
          tol: float, maxiter: int, chunk: int = 64):
    """Fused MG-PCG solve of S x = b on (m, m) f32 grids; returns
    (x (m, m), iterations). CPU tensors take the plain version; CUDA
    tensors launch the kernel (solve.launches counts kernel chunks). On
    the card, solves of one m share a workspace: the MG-PCG is not
    reentrant across streams or threads."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if b.device.type == "cpu":
        return fused_mg_pcg_reference(b, B, C, whier, alpha_s, tol,
                                      maxiter, chunk)
    _nvcc.require_cuda(b)
    return _kernel_solve(b, B, C, whier, alpha_s, tol, maxiter, chunk)


solve.launches = 0


# --------------------------------------- kernel pieces, for comparison

def _piece_sc(dev, alpha_s: float, beta: float = 0.0) -> torch.Tensor:
    sc = torch.zeros(_SC_LEN, dtype=torch.float32)
    sc[_SC_ALPHA], sc[_SC_BETA] = _f32(alpha_s), _f32(beta)
    return sc.to(dev)


def kernel_matvec_update(t0, p_old, B, C, w0, alpha_s: float, beta: float):
    """The kernel's matvec step launched alone: (p', S p') with
    p' = sqf t0 + beta p_old."""
    _nvcc.require_cuda(t0, p_old, B, C, w0)
    lib, m = _lib(), int(t0.shape[0])
    for name, t in (("t0", t0), ("p_old", p_old), ("B", B), ("C", C),
                    ("w0", w0)):
        _check_grid(name, t, (m, m), t0.device)
    pn, Ap = torch.empty_like(t0), torch.empty_like(t0)
    part = torch.empty(int(lib.mgf_fine_blocks(m)), dtype=torch.float32,
                       device=t0.device)
    cnt = torch.zeros(1, dtype=torch.int32, device=t0.device)
    sc = _piece_sc(t0.device, alpha_s, beta)
    _raise_on(lib.mgf_matvec(B.data_ptr(), C.data_ptr(), w0.data_ptr(),
                             t0.data_ptr(), p_old.data_ptr(), pn.data_ptr(),
                             Ap.data_ptr(), part.data_ptr(), cnt.data_ptr(),
                             sc.data_ptr(), m, _nvcc.stream_of(t0)),
              "mgf_matvec")
    return pn, Ap


def kernel_matvec(p, B, C, alpha_s: float):
    """The kernel's S p, launched alone (its matvec step with t0 = 0 and
    beta = 1, so that p' = p)."""
    _nvcc.require_cuda(p)
    zero = torch.zeros_like(p)
    return kernel_matvec_update(zero, p, B, C, zero, alpha_s, 1.0)[1]


def kernel_down(b, w, alpha_s: float):
    """The kernel's down leg of a level above the tail, launched alone."""
    _nvcc.require_cuda(b, w)
    lib, m = _lib(), int(b.shape[0])
    for name, t in (("b", b), ("w", w)):
        _check_grid(name, t, (m, m), b.device)
    if m < 3 or m % 2 == 0:
        raise ValueError(f"restriction needs an odd m >= 3, got {m}")
    mc = (m - 1) // 2 + 1
    bc = torch.empty((mc, mc), dtype=torch.float32, device=b.device)
    sc = _piece_sc(b.device, alpha_s)
    _raise_on(lib.mgf_down(b.data_ptr(), w.data_ptr(), bc.data_ptr(),
                           sc.data_ptr(), m, _nvcc.stream_of(b)), "mgf_down")
    return bc


def kernel_up(b, w, e, alpha_s: float):
    """The kernel's up leg of a level above the tail, launched alone."""
    _nvcc.require_cuda(b, w, e)
    mc = int(e.shape[0])
    if mc < 2:
        raise ValueError(f"prolongation needs a coarse m >= 2, got {mc}")
    m = 2 * mc - 1
    for name, t in (("b", b), ("w", w)):
        _check_grid(name, t, (m, m), e.device)
    _check_grid("e", e, (mc, mc), e.device)
    t = torch.empty_like(b)
    sc = _piece_sc(b.device, alpha_s)
    _raise_on(_lib().mgf_up(b.data_ptr(), w.data_ptr(), e.data_ptr(),
                            t.data_ptr(), sc.data_ptr(), m,
                            _nvcc.stream_of(b)), "mgf_up")
    return t


def kernel_pc(r, B, whier: Sequence[torch.Tensor], alpha_s: float):
    """One preconditioner application z = sqf * V(sqf * r) by the
    kernel's V-cycle (in the solve's workspace for this m)."""
    _nvcc.require_cuda(r, B)
    m, _ = _check_inputs(r, B, B, whier)
    ws = _workspace(m, r.device)
    ws.load(B, whier)
    ws.R0.copy_(r.reshape(-1))
    ws.set_params(alpha_s)
    _raise_on(ws.lib.mgf_pc(ws.handle, _nvcc.stream_of(r)), "mgf_pc")
    return ws.Z.clone().view(m, m)
