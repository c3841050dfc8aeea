"""Fused DIA-CG: the f32 inner Krylov solve of the mixed `pc="jacobi"`
Newton step, as hand-written CUDA kernels (csrc/dia.cu K1/K2, the
counterpart of the reference's ops/pallas_cg.py) with its plain PyTorch
version beside it.

Contract (that of the reference's make_fused_dia_cg / fused_cg): CG with
an identity preconditioner on a DIA operator the caller has already
Jacobi-scaled (models/obstacle_p1.effective_dia), with

    beta = 0 at the first iteration, rr_new / rr_old after it
    K1   p' = r + beta p;  Ap = DIA(p');  partials of p'.Ap
    a    = rr / p'.Ap where good = (p'.Ap > tiny and rr > tiny), else 0
    K2   x += a p';  r -= a Ap;           partials of r.r

best-iterate tracking (the iterate of the smallest r.r is returned) and
the noise-floor stall exit: the loop runs while ok and not stalled and
it < maxiter and rr > stop, stop = tol^2 |b|^2, stalled = no improvement
for stall_window iterations with the best r.r below stall_guard * stop.
A zero b returns x = 0 after 0 iterations.

The reference builds its kernels only when the operator's offsets fit
inside one 512-row TPU block (make_fused_dia_cg returns None otherwise);
the CUDA kernels read neighbours through the cache with explicit bounds
and take any offsets.

The solve runs in chunks of `chunk` iterations, each masked by the loop
condition computed on the device; the host reads it once per chunk.
Every dot product is summed in the kernel's fixed order (ordered_sum),
so kernel and plain version agree bit for bit.

`solve` dispatches on the device of its tensors: a CPU tensor takes
`fused_dia_cg_reference`, a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ._nvcc import require_cuda, stream_of
from .dia_spmv import (check_dtype, check_operator, check_vector,
                       dia_spmv_reference, lib, offsets_arg, raise_on,
                       suffix)

STALL_WINDOW = 128
STALL_GUARD = 1e4

# slots of the kernel's device state vector (csrc/dia.cu SC_*)
_SC_IT, _SC_LIVE, _SC_LEN = 0, 6, 16
_TPB = 256           # threads per block of the grid kernels
_RED_TPB = 1024      # threads of the single-block reductions


def _check_inputs(offsets, data, b) -> Tuple[int, ...]:
    check_dtype(b)
    if b.dim() != 1 or b.shape[0] < 1:
        raise ValueError(f"b must be a non-empty vector, got shape "
                         f"{tuple(b.shape)}")
    check_vector("b", b, int(b.shape[0]), b.device, b.dtype)
    return check_operator(offsets, data, int(b.shape[0]), b.device, b.dtype)


# ------------------------------------------------------ plain version

def _tree(v: torch.Tensor) -> torch.Tensor:
    """Pairwise halving over the last axis (a power of two), as the
    kernels' block tree sums it."""
    w = v.shape[-1]
    while w > 1:
        w //= 2
        v = v[..., :w] + v[..., w:2 * w]
    return v[..., 0]


def block_partials(v: torch.Tensor) -> torch.Tensor:
    """Per-block sums of v as the grid kernels write them: blocks of
    _TPB entries, a tree in each."""
    nb = -(-v.shape[0] // _TPB)
    return _tree(F.pad(v, (0, nb * _TPB - v.shape[0])).reshape(nb, _TPB))


def sum_partials(part: torch.Tensor) -> torch.Tensor:
    """The single-block reduction of the block partials: _RED_TPB strided
    running sums in order, then a tree."""
    k = -(-part.shape[0] // _RED_TPB)
    rows = F.pad(part, (0, k * _RED_TPB - part.shape[0])).reshape(
        k, _RED_TPB)
    acc = torch.zeros(_RED_TPB, dtype=part.dtype, device=part.device)
    for row in rows:
        acc = acc + row
    return _tree(acc)


def ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """sum(v) in the kernels' fixed order (a 0-d tensor)."""
    return sum_partials(block_partials(v))


def k1_reference(offsets, data, r, p, beta):
    """Plain K1: (p' = r + beta p, Ap = DIA(p'), partials of p'.Ap)."""
    pn = r + beta * p
    Ap = dia_spmv_reference(offsets, data, pn)
    return pn, Ap, block_partials(pn * Ap)


def k2_reference(x, r, p, Ap, a):
    """Plain K2: (x + a p, r - a Ap, partials of r.r)."""
    x = x + a * p
    r = r - a * Ap
    return x, r, block_partials(r * r)


def fused_dia_cg_reference(offsets: Sequence[int], data: torch.Tensor,
                           b: torch.Tensor, tol: float, maxiter: int,
                           stall_guard: float = STALL_GUARD,
                           stall_window: int = STALL_WINDOW,
                           chunk: int = 64):
    """Plain PyTorch version of the kernels: same algorithm, same sums,
    same chunked control flow. Returns (x, iterations)."""
    offs = _check_inputs(offsets, data, b)
    dt, dev = b.dtype, b.device

    def scalar(v):
        return torch.tensor(v, dtype=dt, device=dev)

    tiny = torch.finfo(dt).tiny
    tol_t = scalar(tol)
    x = torch.zeros_like(b)
    r = b
    p = torch.zeros_like(b)
    xb = torch.zeros_like(b)
    rr = ordered_sum(r * r)
    stop = tol_t * tol_t * rr
    guard_stop = scalar(stall_guard) * stop
    it, ib, ok, beta = scalar(0.0), scalar(0.0), scalar(1.0), scalar(0.0)
    rrb = rr

    def live_of(it, ib, rrb, ok, rr):
        stalled = (it - ib > stall_window) & (rrb < guard_stop)
        return (ok > 0.5) & ~stalled & (it < maxiter) & (rr > stop)

    while bool(live_of(it, ib, rrb, ok, rr)):      # one read per chunk
        for _ in range(chunk):
            live = live_of(it, ib, rrb, ok, rr)
            pn, Ap, part = k1_reference(offs, data, r, p, beta)
            pAp = sum_partials(part)
            good = (pAp > tiny) & (rr > tiny)
            a = torch.where(good, rr / torch.where(good, pAp, 1.0), 0.0)
            xn, rn, part = k2_reference(x, r, pn, Ap, a)
            rr_new = sum_partials(part)
            better = live & (rr_new < rrb)
            x = torch.where(live, xn, x)
            r = torch.where(live, rn, r)
            p = torch.where(live, pn, p)
            xb = torch.where(better, x, xb)
            rrb = torch.where(better, rr_new, rrb)
            ib = torch.where(better, it + 1.0, ib)
            beta = torch.where(live, rr_new / rr, beta)
            rr = torch.where(live, rr_new, rr)
            ok = torch.where(live, good.to(dt), ok)
            it = torch.where(live, it + 1.0, it)
    return xb, int(it)


# ------------------------------------------------------------- kernel

def _kernel_solve(offs, data, b, tol, maxiter, stall_guard, stall_window,
                  chunk):
    n, dev = int(b.shape[0]), b.device
    x = torch.zeros_like(b)
    r = b.clone()
    p0 = torch.zeros_like(b)
    p1 = torch.zeros_like(b)
    Ap = torch.empty_like(b)
    xb = torch.zeros_like(b)
    part = torch.empty(-(-n // _TPB), dtype=b.dtype, device=dev)
    sc = torch.zeros(_SC_LEN, dtype=b.dtype, device=dev)
    fn = getattr(lib(), f"dcg_chunk_{suffix(b)}")
    c_offs = offsets_arg(offs)
    stream = stream_of(b)
    queued = 0
    while True:
        err = fn(data.data_ptr(), c_offs, len(offs), x.data_ptr(),
                 r.data_ptr(), p0.data_ptr(), p1.data_ptr(), Ap.data_ptr(),
                 xb.data_ptr(), part.data_ptr(), sc.data_ptr(), n, chunk,
                 int(queued == 0), queued % 2, float(tol), float(maxiter),
                 float(stall_window), float(stall_guard), stream)
        raise_on(err, "dcg_chunk")
        solve.launches += chunk
        queued += chunk
        # the one host read of the chunk: iterations and the loop condition
        it, live = sc[[_SC_IT, _SC_LIVE]].tolist()
        if live < 0.5:
            return xb, int(it)


def solve(offsets: Sequence[int], data_eff: torch.Tensor, b: torch.Tensor,
          tol: float, maxiter: int, stall_guard: float = STALL_GUARD,
          stall_window: int = STALL_WINDOW, chunk: int = 64):
    """Fused DIA-CG solve of A x = b for the DIA operator (offsets,
    data_eff (ndiags, N)), f32 or f64; returns (x, iterations). CPU
    tensors take the plain version; CUDA tensors launch the kernels
    (solve.launches counts the iterations queued on the card, each one
    launch of K1 and one of K2)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if b.device.type == "cpu":
        return fused_dia_cg_reference(offsets, data_eff, b, tol, maxiter,
                                      stall_guard, stall_window, chunk)
    require_cuda(b)
    offs = _check_inputs(offsets, data_eff, b)
    return _kernel_solve(offs, data_eff, b, tol, maxiter, stall_guard,
                         stall_window, chunk)


solve.launches = 0


# --------------------------------------- kernel pieces, for comparison

def kernel_k1(offsets, data, r, p, beta: float):
    """The kernel's K1, launched once: (p', Ap, partials of p'.Ap)."""
    require_cuda(r, p)
    offs = _check_inputs(offsets, data, r)
    n = int(r.shape[0])
    check_vector("p", p, n, r.device, r.dtype)
    pn, Ap = torch.empty_like(r), torch.empty_like(r)
    part = torch.empty(-(-n // _TPB), dtype=r.dtype, device=r.device)
    c_offs = offsets_arg(offs)
    raise_on(getattr(lib(), f"dcg_k1_{suffix(r)}")(
        data.data_ptr(), c_offs, len(offs), r.data_ptr(), p.data_ptr(),
        pn.data_ptr(), Ap.data_ptr(), part.data_ptr(), float(beta), n,
        stream_of(r)), "dcg_k1")
    return pn, Ap, part


def kernel_k2(x, r, p, Ap, a: float):
    """The kernel's K2, launched once: x += a p and r -= a Ap in place, as
    in the solve; returns (x, r, partials of r.r)."""
    require_cuda(x, r, p, Ap)
    check_dtype(x)
    n = int(x.shape[0])
    for name, t in (("x", x), ("r", r), ("p", p), ("Ap", Ap)):
        check_vector(name, t, n, x.device, x.dtype)
    part = torch.empty(-(-n // _TPB), dtype=x.dtype, device=x.device)
    raise_on(getattr(lib(), f"dcg_k2_{suffix(x)}")(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(),
        part.data_ptr(), float(a), n, stream_of(x)), "dcg_k2")
    return x, r, part
