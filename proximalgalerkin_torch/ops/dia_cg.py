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

On the card an iteration is two launches, K1 and K2; each ends its dot
product in its own last block, which also does the iteration's scalar
work (csrc/dia.cu says what bounds them and what the design does about
it). K1's blocks are as many as the card holds at once; each works
through bands of four 256-row runs and keeps the asynchronous copies of
its next band in flight, into a ring of shared-memory stages, while it
computes one. A stage holds the band's matrix rows and, for each
cluster of neighbouring offsets (stage_plan), r and p over the band
shifted by the cluster; p' is computed there once and read from there by
every diagonal of the cluster. Offsets outside every cluster are read
through the cache with explicit bounds, so any offsets work (the
reference builds its kernels only when they fit inside one 512-row TPU
block). The best iterate is never copied: x lives in three buffers, and
K2 writes into the one that holds neither the current nor the best.

A solve runs in chunks of `chunk` iterations, each masked by the loop
condition computed on the device. A chunk is one CUDA graph, captured at
first use and replayed: one host call and one host read per chunk. The
graphs belong to a workspace, one per (device, n, offsets, dtype), that
holds everything a captured kernel sees at fixed addresses: the vectors,
the partial sums, the device state vector (with tol, maxiter, the stall
window and guard) and a copy of the matrix. The matrix is copied in at
every solve (it changes with every Newton step; 29 MB at 1024^2, some
tens of microseconds on the card) rather than read through a pointer in
device memory, because the copy is also where its rows get a pitch that
is a multiple of 16 bytes: a (ndiag, N) array with odd N cannot be read
with 16-byte copies. The p buffer of an iteration is picked on the device
by the parity of the iteration count, so one graph per (chunk, first)
serves every chunk of every solve. A workspace is not reentrant: one
solve at a time, on one stream.

Every dot product is summed in the kernel's fixed order (ordered_sum),
so kernel and plain version agree bit for bit.

`solve` dispatches on the device of its tensors: a CPU tensor takes
`fused_dia_cg_reference`, a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ._nvcc import require_cuda, stream_of
from .dia_spmv import (check_dtype, check_operator, check_vector,
                       dia_spmv_reference, lib, offsets_arg)

STALL_WINDOW = 128
STALL_GUARD = 1e4

# slots of the kernel's device state vector (csrc/dia.cu SC_*): the
# solve's state, then its parameters from _SC_TOL on
_SC = dict(IT=0, RR=1, LIVE=6, A=7, BETA=9, BEST=11)
_SC_TOL, _SC_LEN = 16, 32
_TPB = 256           # rows of one partial sum (a run)
_RED_TPB = 1024      # strided lanes of the sum over the partials
_ROWS = 4            # rows of one 16-byte copy of f32
_PAD = 64            # buffers are padded to this many values
_NVEC = 7            # vectors of a workspace (csrc/dia.cu NVEC)
_CLUSTER_GAP = 32    # offsets this close share a staged segment
_MAX_CLUSTERS = 8    # csrc/dia.cu MAX_CLUSTERS
# Dynamic shared memory a K1 block may use: Hopper's 227 KB a block, less
# 1 KB for the kernel's static shared memory. stage_plan alone divides it;
# the kernel library takes the plan as given and the card refuses a launch
# that asks for more.
_K1_SMEM = 226 * 1024
# K1's band in runs and the stages of its ring, in order of preference
_RINGS = ((4, 2), (1, 2), (1, 1))


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


# ------------------------------------------- the kernel's host geometry

def _padded(k: int) -> int:
    return -(-k // _PAD) * _PAD


def cluster_offsets(offsets: Sequence[int]):
    """Groups of two or more offsets in which neighbours lie at most
    _CLUSTER_GAP apart. Returns (clusters, member): clusters as (lo, hi) in
    ascending order, and for each diagonal, in the order given, the index
    of its cluster or -1."""
    order = sorted(range(len(offsets)), key=lambda d: offsets[d])
    groups, cur = [], []
    for d in order:
        if cur and offsets[d] - offsets[cur[-1]] > _CLUSTER_GAP:
            groups.append(cur)
            cur = []
        cur.append(d)
    if cur:
        groups.append(cur)
    clusters, member = [], [-1] * len(offsets)
    for g in groups:
        if len(g) < 2:
            continue
        for d in g:
            member[d] = len(clusters)
        clusters.append((offsets[g[0]], offsets[g[-1]]))
    return tuple(clusters), tuple(member)


class StagePlan(NamedTuple):
    """K1's staging plan (csrc/dia.cu Plan). K1 works through bands of
    `runs` runs of 256 rows, staged in a ring of `stages` stages. Diagonal d reads p' from staged segment
    member[d], or r and p through the cache when member[d] is -1.
    Segment c holds rows [s0 + start[c], s0 + start[c] + length[c]) of a
    band starting at row s0, clipped to the matrix."""
    runs: int
    stages: int
    member: Tuple[int, ...]
    start: Tuple[int, ...]
    length: Tuple[int, ...]


def stage_values(nd: int, runs: int, rows: int) -> int:
    """Values in one stage of K1's shared-memory ring (the layout of
    csrc/dia.cu stage_values): the nd matrix rows of a band of `runs`
    runs, and r and p over the `rows` staged rows of its segments."""
    return nd * runs * _TPB + 2 * rows


def k1_smem_bytes(nd: int, plan: StagePlan, itemsize: int) -> int:
    """Dynamic shared memory of a K1 block under `plan`: one value a
    thread and run for the run sums, then the ring."""
    stage = stage_values(nd, plan.runs, sum(plan.length))
    return (plan.runs * _TPB + plan.stages * stage) * itemsize


def stage_plan(offsets: Sequence[int], itemsize: int) -> StagePlan:
    """The clusters of `offsets` laid out for K1, within _K1_SMEM. The
    band and the ring are the first of _RINGS whose matrix rows alone
    fit: four runs in two stages, else one run in two stages, else one
    run in one stage. Each segment starts on a multiple of four rows at or
    below its cluster's lowest offset and covers the band shifted by
    every offset of the cluster. Clusters are taken in order of their
    number of diagonals; one that would make a stage too large (or is
    one too many) is left out: its diagonals read through the cache."""
    nd = len(offsets)
    for runs, stages in _RINGS:
        # values one stage may hold
        budget = (_K1_SMEM // itemsize - runs * _TPB) // stages
        if stage_values(nd, runs, 0) <= budget:
            break
    else:
        raise ValueError(f"{nd} diagonals do not fit K1's shared memory")
    clusters, member = cluster_offsets(offsets)
    start, length, kept = [], [], {}
    for c in sorted(range(len(clusters)), key=lambda c: -member.count(c)):
        lo, hi = clusters[c]
        s = lo // _ROWS * _ROWS
        ln = -(-(runs * _TPB + hi - s) // _ROWS) * _ROWS
        values = stage_values(nd, runs, sum(length) + ln)
        if len(start) == _MAX_CLUSTERS or values > budget:
            continue
        kept[c] = len(start)
        start.append(s)
        length.append(ln)
    return StagePlan(runs, stages, tuple(kept.get(c, -1) for c in member),
                     tuple(start), tuple(length))


# ------------------------------------------------------------- kernel

def _raise_on(err: int, what: str, lib_):
    if err != 0:
        msg = lib_.dia_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _graph_key(chunk: int, first: bool) -> Tuple[int, bool]:
    """A chunk's graph depends on its length and on whether it primes."""
    return int(chunk), bool(first)


class _Workspace:
    """The kernels' device buffers for one (n, offsets, dtype), and the
    chunk graphs captured over them (one per _graph_key). Every pointer a
    captured kernel sees stays fixed, so a graph serves every solve.

    One buffer holds the seven vectors (three x buffers, r, p0, p1, Ap,
    each padded to a multiple of _PAD values), the matrix with padded
    rows (data: (ndiag, pitch)), the partial sums and the state vector.
    K2 writes x + a p' into the x buffer that holds neither the current
    nor the best iterate; sc says which buffer holds which."""

    def __init__(self, lib_, n: int, offs: Tuple[int, ...], dtype, dev):
        item = torch.empty((), dtype=dtype).element_size()
        self.lib, self.n, self.offs = lib_, n, offs
        self.plan = plan = stage_plan(offs, item)
        nd, npad, nb = len(offs), _padded(n), -(-n // _TPB)
        self.pitch = pitch = npad
        self.buf = torch.zeros(_NVEC * npad + nd * pitch + _padded(nb)
                               + _SC_LEN,
                               dtype=dtype, device=dev)
        self.cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        vec = self.buf[:_NVEC * npad].view(_NVEC, npad)
        self.xs = vec[:3, :n]
        self.r, self.p0, self.p1, self.Ap = (v[:n] for v in vec[3:])
        o = _NVEC * npad
        self.data_padded = self.buf[o:o + nd * pitch].view(nd, pitch)
        self.data = self.data_padded[:, :n]
        o += nd * pitch
        self.part = self.buf[o:o + nb]
        o += _padded(nb)
        self.sc = self.buf[o:o + _SC_LEN]
        err = ctypes.c_int(0)
        handle = lib_.dcg_ws_create(
            int(item == 8), n, pitch, npad, nd, offsets_arg(offs),
            offsets_arg(plan.member), len(plan.start),
            offsets_arg(plan.start), offsets_arg(plan.length), plan.runs,
            plan.stages, self.data_padded.data_ptr(), vec.data_ptr(),
            self.part.data_ptr(), self.sc.data_ptr(), self.cnt.data_ptr(),
            ctypes.byref(err))
        _raise_on(err.value, "dcg_ws_create", lib_)
        if not handle:
            raise RuntimeError(f"dcg_ws_create failed for n={n}")
        self.handle = handle
        self.graphs: Dict[Tuple[int, bool], int] = {}
        # the plan was sized for this layout of a stage; the kernel's must
        # be the same
        want, got = k1_smem_bytes(nd, plan, item), self.k1_shape()[1]
        if got != want:
            self.close()
            raise RuntimeError(f"K1 takes {got} B of shared memory where "
                               f"its plan counted {want} B")

    def k1_shape(self) -> Tuple[int, int]:
        """K1's launch on this card: (blocks, bytes of dynamic shared
        memory a block)."""
        out = [ctypes.c_int(0) for _ in range(2)]
        self.lib.dcg_ws_info(self.handle, *(ctypes.byref(v) for v in out))
        return tuple(v.value for v in out)

    def load(self, data: torch.Tensor):
        """Copies the matrix (ndiag, n) into its padded rows (on the
        caller's stream)."""
        self.data.copy_(data)

    def set_state(self, **slots: float):
        """Writes sc anew: zeros but for the slots named (by the keys of
        _SC)."""
        sc = torch.zeros(_SC_LEN, dtype=self.sc.dtype)
        for name, v in slots.items():
            sc[_SC[name]] = v
        self.sc.copy_(sc)

    def set_params(self, tol: float, maxiter: int, window: float,
                   guard: float):
        """tol, maxiter, the stall window and guard into sc."""
        self.sc[_SC_TOL:_SC_TOL + 4] = torch.tensor(
            [tol, float(maxiter), float(window), guard], dtype=self.sc.dtype)

    def graph(self, chunk: int, first: bool) -> int:
        """The instantiated graph of a chunk, captured at first use."""
        key = _graph_key(chunk, first)
        if key not in self.graphs:
            err = ctypes.c_int(0)
            g = self.lib.dcg_capture(self.handle, key[0], int(key[1]),
                                     ctypes.byref(err))
            _raise_on(err.value, "dcg_capture", self.lib)
            if not g:
                raise RuntimeError("dcg_capture returned no graph")
            self.graphs[key] = g
        return self.graphs[key]

    def launch(self, chunk: int, first: bool, stream: int):
        _raise_on(self.lib.dcg_launch(self.graph(chunk, first), stream),
                  "dcg_launch", self.lib)

    def close(self):
        """Destroys the graphs and the workspace (after the device is done
        with them)."""
        for g in self.graphs.values():
            self.lib.dcg_graph_destroy(g)
        self.graphs.clear()
        if self.handle:
            self.lib.dcg_ws_destroy(self.handle)
            self.handle = None


_workspaces: Dict[tuple, _Workspace] = {}


def release_workspaces():
    """Frees every cached workspace and its graphs; the next solve builds
    them anew."""
    for dev in {key[0] for key in _workspaces}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    for ws in _workspaces.values():
        ws.close()
    _workspaces.clear()


def _workspace(offs: Tuple[int, ...], like: torch.Tensor) -> _Workspace:
    """The workspace for vectors like `like` and these offsets, made at
    first use and shared by every solve and kernel_k1 / kernel_k2 call
    there (not reentrant: one at a time)."""
    key = (like.device, int(like.shape[0]), offs, like.dtype)
    if key not in _workspaces:
        _workspaces[key] = _Workspace(lib(), key[1], offs, like.dtype,
                                      like.device)
    return _workspaces[key]


def _kernel_solve(offs, data, b, tol, maxiter, stall_guard, stall_window,
                  chunk):
    ws = _workspace(offs, b)
    ws.load(data)
    ws.r.copy_(b)
    ws.set_params(tol, maxiter, stall_window, stall_guard)
    stream = stream_of(b)
    first = True
    while True:
        ws.launch(chunk, first, stream)
        solve.launches += chunk
        solve.replays += 1
        first = False
        # the one host read of the chunk: iterations and the loop condition
        # and the x buffer of the best iterate
        it, live, best = ws.sc[[_SC["IT"], _SC["LIVE"], _SC["BEST"]]].tolist()
        if live < 0.5:
            return ws.xs[int(best)].clone(), int(it)


def solve(offsets: Sequence[int], data_eff: torch.Tensor, b: torch.Tensor,
          tol: float, maxiter: int, stall_guard: float = STALL_GUARD,
          stall_window: int = STALL_WINDOW, chunk: int = 64):
    """Fused DIA-CG solve of A x = b for the DIA operator (offsets,
    data_eff (ndiags, N)), f32 or f64; returns (x, iterations). CPU
    tensors take the plain version; CUDA tensors launch the kernels:
    solve.launches counts the iterations queued on the card, each one
    launch of K1 and one of K2, and solve.replays the chunk graphs
    replayed, each one host call and one host read. On the card, solves
    of one operator shape share a workspace: not reentrant across streams
    or threads."""
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
solve.replays = 0


# --------------------------------------- kernel pieces, for comparison

def kernel_k1(offsets, data, r, p, beta: float):
    """The solve's K1, launched once on its workspace with the given r,
    p and beta: (p', Ap, partials of p'.Ap)."""
    require_cuda(r, p)
    offs = _check_inputs(offsets, data, r)
    check_vector("p", p, int(r.shape[0]), r.device, r.dtype)
    ws = _workspace(offs, r)
    ws.load(data)
    ws.r.copy_(r)
    ws.p0.copy_(p)
    ws.cnt.zero_()
    ws.set_state(LIVE=1.0, BETA=beta, RR=1.0)   # iteration 0: p0 -> p1
    _raise_on(ws.lib.dcg_k1(ws.handle, stream_of(r)), "dcg_k1", ws.lib)
    return ws.p1.clone(), ws.Ap.clone(), ws.part.clone()


def kernel_k2(offsets, x, r, p, Ap, a: float):
    """The solve's K2, launched once on the workspace of these offsets
    (K2 reads no matrix) with the given x, r, p', Ap and a: (x + a p',
    r - a Ap, partials of r.r). The arguments are left as they are."""
    require_cuda(x, r, p, Ap)
    check_dtype(x)
    n = int(x.shape[0])
    for name, t in (("x", x), ("r", r), ("p", p), ("Ap", Ap)):
        check_vector(name, t, n, x.device, x.dtype)
    ws = _workspace(tuple(int(o) for o in offsets), x)
    for dst, src in ((ws.xs[0], x), (ws.r, r), (ws.p1, p), (ws.Ap, Ap)):
        dst.copy_(src)
    ws.cnt.zero_()
    # iteration 0: p' in p1; x in buffer 0 (current and best), x' into 1
    ws.set_state(LIVE=1.0, A=a, RR=1.0)
    _raise_on(ws.lib.dcg_k2(ws.handle, stream_of(x)), "dcg_k2", ws.lib)
    return ws.xs[1].clone(), ws.r.clone(), ws.part.clone()
