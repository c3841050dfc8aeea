"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py              # the smoke run
    python3 chip_smoke.py --ab PARENT  # A/B of the 1024^2 solves only
    python3 chip_smoke.py --sizes [NAME ...]
                                       # phases 8 and 9 at two sizes each,
                                       # three models at their CLI sizes,
                                       # the whole 24^2 multiphase record,
                                       # phase 12 (iv) at four sizes, the
                                       # first LVPP step of the 200^2
                                       # gradient constraint (schur_mg),
                                       # the matrix-free eikonal, the
                                       # whole res 0.06 Signorini
                                       # trajectory, the 224^2
                                       # distributed obstacle's 4 LVPP
                                       # steps, the 29-step distributed
                                       # fracture, the halo FD at
                                       # N = 1025, the three btlu
                                       # device records (SIZES)
    python3 chip_smoke.py --record KEY # one MULTIPHASE_RECORDS run, as a
                                       # JSON line, the eikonal ball
                                       # (eikonal_ball) or the btlu
                                       # records' depth cuts
                                       # (btlu_cuts): the children of
                                       # phases 11 (iv), 11 (vi) and
                                       # 12 (ii)
    python3 chip_smoke.py --cpu-cases GROUP OUT
                                       # the CPU halves of phase GROUP's
                                       # (i) checks, pickled to OUT (a
                                       # child of the smoke run)

Phases, each printing its own lines; any failure exits non-zero:

1. the card (nvidia-smi name and power limit, torch and CUDA versions);
2. build of the CUDA kernels (csrc/mgfused.cu, csrc/dia.cu, csrc/ebe.cu
   and csrc/btapply.cu) from the sources, one nvcc for each, started
   together;
3. the fused MG-PCG kernel against its plain PyTorch version on the card,
   at m = 1025 on a deep-contact Schur state made with numpy from a seed:
   its pieces (matvec step, down and up legs of a level, one V-cycle, the
   V-cycle bit for bit against its plain version split as planned), a
   whole solve with its time per iteration beside its bound and its
   device time by kernel and idle share (torch.profiler), the bottom of
   the V-cycle below level 1 (the cluster k_tail) a launch, chunk-size
   invariance (64/5/1, m = 257), a zero right-hand side, maxiter, and
   workspace reuse;
4. the DIA SpMV kernel against its plain version: the 1024^2 P1 operator
   in f64 and f32 and the reference golden's 17x13 shape, and its times
   beside a CSR torch.sparse product of the same operator (a yardstick
   the port never calls);
5. the fused DIA-CG kernels (K1, K2 and the chunked solve) against their
   plain version, bit for bit: the reference golden's SPD system (f64), a
   1025^2 Jacobi-scaled deep-contact Schur operator (f32), 2,000
   iterations on the scaled Laplacian, chunk-size invariance (64/5/1,
   m = 257), a zero right-hand side, maxiter, two solves with different
   matrices in one workspace against fresh workspaces, the kernels the
   profiler sees in a solve (two per iteration, one graph replay and one
   host read per chunk), and their times;
6. the main path, mixed precision with pc="mg": a 32^2 solve on the card
   held against the same solve on the CPU, then the 1024^2 LVPP obstacle
   solve (2,101,250 dofs) after the bench's warm-up Newton solve
   (cli.warmup_newton), checked for convergence, feasibility, kernel
   launches, no chunk graph captured in the timed solve, and its outer,
   Newton and CG counts and the hash of u (MAIN_PATH_PINS), with its time
   per CG iteration and the device's idle share over outer step 1;
7. the main path with pc="jacobi": the same two solves with the same
   readings, the 1024^2 solution held against the mg one, and
   solve_fused() at 32^2;
8. the FD obstacle (models/obstacle_fd.py) at the bench's width,
   N = 1025 (2,101,250 dofs), outer tolerance 1e-8: first held against
   the port's CPU run of the same code at N = 65 (Newton counts equal, u
   within 1e-10), then converged and feasible, with its counts, time per
   CG iteration, host reads and the idle share of the first Newton step
   of outer step 1;
9. the general LVPP stack (models/obstacle.py) on the 160^2 P1 mesh
   (51,842 dofs): (a) the whole run with the reference's default
   direction (element matrices on the card, SuperLU on the host) and its
   PhaseTimer report, (b) its first two outer steps with the device
   MINRES/Jacobi/ELL direction, held against (a): Newton counts equal, x
   within 1e-8. Phases 8 and 9 launch none of the port's CUDA kernels;
10. the LVPP example models on the general stack (spectral obstacle,
   intersecting, eigenvalue, thermoforming and its three baselines,
   gradient constraint, fracture): (i) each at the smallest case of its
   CPU parity test on the card and on the CPU (counts equal, fields
   within 1e-10 relative; thermoforming 1e-7, FIELD_RTOL), then, after
   phase 11 (i) and (iv), (ii) each at its record size
   (RESULTS.md:159-171; thermoforming cut to its first
   THERMOFORMING_HELD_STEPS LVPP steps, fracture to its first
   FRACTURE_LOAD_STEPS load steps): its counts beside the JAX
   package's CPU counts pinned here (REFERENCE_COUNTS; they must be
   equal over the steps run), the reference
   test's physical checks, its seconds, PhaseTimer report and peak
   device memory, and zero launches of the port's CUDA kernels;
11. the block-tridiagonal direct direction (la/blocktri.py,
   pc_type='btlu') and the multiphase model (models/multiphase.py), as
   torch ops on the card: (i) the smallest case of each new CPU parity
   test on the card and on the CPU (gradient constraint 12^2 P2 with
   btlu Thomas f32, cyclic reduction, streamed and lagged f64 factor /
   f32 apply; multiphase N = 10, two steps, with LU and with the fused
   lagged btlu): counts equal, fields within 1e-10 relative; (ii) phase
   9's 160^2 obstacle with btlu, f64 and f32 factor, held to (a)'s LU
   outcome (the JAX package's CPU runs break down at outer step 6-7,
   its equilibration scaling latent rows by diagonals near underflow;
   la/blocktri._equilibrate); (iii) gradient constraint 48^2 P2 and
   eigenvalue 20^2 P3 with btlu (counts equal to the pinned LU ones); (iv) multiphase at
   24^2, dt 1e-4, the first of the record's 5 steps, default LU (host
   SuperLU, in a child process on the same card beside phases 10 (i),
   11 (i) and 12 (i), which time nothing and whose CPU halves run in
   three more children; the timed runs start after they have ended); (v)
   multiphase
   at 50^2 (61,212 dofs), its first 5 steps of dt 1e-5 through the fused
   lagged btlu (f64 factor, f32 apply, lag 1, snes_fused_chunk 3):
   per-step counts equal to the JAX package's CPU counts pinned here,
   mass conserved to 1e-10, simplex row sums within 1e-6; each with its
   seconds, factor/solve shares, refactors, PhaseTimer report and peak
   device memory, and the launches of the port's CUDA kernels (the
   block-Thomas apply, csrc/btapply.cu, where a dense block-Thomas factor
   is applied: the btlu runs but the streamed factor, the (i) cases of
   Thomas and the lagged factor, (v); none else); then the time of one
   factor and one apply at the block shapes of (ii) and (v);
   (vi) depth cuts of the JAX package's all-device btlu records
   (BTLU_RECORDS), in a child process beside the (i) checks as (iv):
   example 01's disk at res 0.0085 (101,000 dofs), its first LVPP step
   (Newton [5]), and the eigenvalue constraints at 100^2 P3 (362,404
   dofs), its first Newton step with the streamed factor, each with its
   seconds, shares, refactors, blocking and peak device memory;
12. the block-Schur preconditioners (la/schur.py, la/gmg.py,
   pc_type='schur'/'schur_mg', mixed precision under them) and the
   eikonal and Monge–Ampère models, as torch ops on the card: (i) the
   smallest case of each new CPU parity test on the card and on the CPU
   (a lattice V-cycle; eikonal 12x3 with LU and Schur-MINRES, the star
   at res 0.12; the first LVPP step of gradient constraint 8^2 P2 with
   the fused Newton and schur, and its first Newton step through
   solve_gradient_constraint with schur_mg in double and mixed
   precision; Monge–Ampère k = 3, 4): counts equal, fields within 1e-10
   relative (1e-8 for the MINRES directions), beside phase 11 (iv)'s
   child; (ii) the eikonal records: the Möbius strip 48x6 with LU and
   with the Schur-MINRES default, the star at res 0.08 and the ball at
   res 0.3 with LU (the ball, 118-141 s of host SuperLU, in a child
   process beside the (i) checks, as phase 11 (iv)); (iii) the
   Monge–Ampère
   p-sweep k = 3..8: counts
   equal to the JAX package's CPU counts pinned here, the reference
   tests' checks; (iv) the gradient constraint at its CLI width, 200^2
   P2 (241,603 dofs), with minres / schur_mg / mixed / block0 psi,
   through solve_gradient_constraint capped at one Newton step
   (GRADIENT_200): its pinned outcome (GRADIENT_FIRST_STEP), the step
   lowering |F| and its direction's relative residual under
   GRADIENT_200_RESIDUAL; each with its seconds, MINRES
   iterations a Newton step, ms a MINRES iteration, the shares of
   element matrices, preconditioner builds and MINRES, its PhaseTimer
   report, peak device memory, and zero launches of the port's CUDA
   kernels;
13. Signorini contact (spaces/trace.py, assembly/facets.py,
   solve/composite.py, models/signorini.py), the bound-constrained
   baselines (solve/optimization.py, solve/vi.py, models/obstacle_qp.py),
   utils/profiling.py and bench --mode fd|stream, as torch ops on the
   card with host SuperLU: (i) the smallest case of each new CPU parity
   test on the card and on the CPU (Signorini half-disk res 0.06 and
   half-sphere res 0.16, compare_all on the 12^2 rectangle): counts
   equal, fields within 1e-10 relative, beside phase 11 (iv)'s child;
   (ii) the records (RESULTS.md:160-162): the half-disk at res 0.04
   pressed by 0.10, 0.15 and 0.20, the half-sphere at res 0.12, the five
   solvers on the disk at res 0.1, their counts equal to the JAX
   package's CPU counts pinned here and the reference tests' checks;
   (iii) the half-sphere at res 0.06 (13,883 cells, 8,317 dofs), its
   first SIGNORINI_WIDTH_STEPS LVPP steps, counts pinned likewise; each
   with its seconds, PhaseTimer shares, peak device memory and zero
   launches of the port's CUDA kernels; (iv) one Signorini Newton step
   inside utils.profiling.device_trace in a span of its own (the trace
   file, the span's range and the card's kernels in it), then `bench
   --mode stream` and `bench --mode fd -n 1024` in a child each (the FD
   counts equal phase 8's);
14. the distributed layer (parallel/: comm.py, halo.py, sharding.py,
   dofpart.py, multihost.py), as torch ops on the card with 8
   subdomains on its shard axis: (i) the smallest case of each new CPU
   parity test on the card and on the CPU (dofpart's residual and
   Jacobian action on the disk res 0.2 P1 and the 13x11 P2 rectangle,
   the 3-step distributed LVPP on the disk res 0.25,
   fd_obstacle_solve_sharded(33)): counts equal, fields within 1e-10
   relative, the CPU halves in a fifth CpuCases child; (ii) the JAX
   package's distributed records: the 96^2 obstacle with asm_btlu, 3
   LVPP steps (Newton [5, 4, 3], u held to the port's host-LU run
   within 1e-8), the first LVPP step of the 224^2 obstacle (101,250
   dofs; Newton 5; owned dofs, ext_total, nb x bs beside the record's),
   each with the ms of one Jacobian action (the jvp eager and as a CUDA
   graph, the element-matrix action as a CUDA graph, with its device
   operations) and of one exchange, the distributed fracture at res 0.1
   with MINRES on the matrix-free action, its first FRACTURE_DIST_STEPS
   load steps, and fd_obstacle_solve_sharded(257) on 8 strips, their
   counts pinned from the JAX package's CPU runs, each with its seconds,
   the shares of residuals, Jacobian actions, cell element matrices,
   Schwarz factors and applies (DistTally), peak device memory and the
   launches of the port's CUDA kernels (the element-by-element product
   and the block-Thomas apply on the Schwarz paths, none else); (iii)
   init_multihost on NCCL at
   world size 1: the disk-0.25 obstacle on 4 subdomains through the
   process group bit for bit equal to the in-process run; (iv) the
   element-by-element product kernel (csrc/ebe.cu) against its plain
   version at the 224^2 cell's shapes (its gathers, 100,352 cells, L =
   6) and at a vector field's L = 9, within 1e-13 relative, with its
   device time beside its bound and the plain version's time; (v) the
   block-Thomas apply kernel (csrc/btapply.cu) against its plain
   version at the 224^2 cell's blocking (8 subdomains, 253 x 151) and
   the disk cell's (97 x 200), f64, within 1e-12 relative and bit for
   bit between two launches, with its device time beside its bound, the
   plain version's time and its launch geometry;
15. a JSON line of the kernels, then the JSON status line.

Lines starting "--" give the time into the run at which each group of
phases ended.

The kernel launch counters are set to 0 just before each 1024^2 solve and
read just after it.

With --ab PARENT (PARENT: an unpacked copy of another commit of the
repository), the 1024^2 mixed + mg solve of PARENT's package and of this
one run in turns (parent, this, this, parent), each in its own process,
then the mixed + jacobi solve likewise; each line gives the solve's
seconds, its time per CG iteration, its counts and a hash of u (and, for
mg, the launches below level 1 of the V-cycle at m = 1025 with their
device time, tail_chain), and the jacobi solutions are held against the
mg one.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from proximalgalerkin_torch.core.logging import tracing

SEED = 0
T_START = time.perf_counter()
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| / max |ref|."""
    return float((a - ref).abs().max() / ref.abs().max())


def deep_contact_state(m: int, seed: int):
    """The deep-contact Schur state of the reference's fused MG-PCG tests
    (tests/test_mgfused.py::_setup: diagonal jumps of 1e10 in a disc of
    contact), as numpy arrays: (alpha, free, B, C, w0, b, sqrt(diagS))."""
    PIN = 1e18
    N = m * m
    rng = np.random.default_rng(seed)
    interior = np.ones((m, m))
    interior[[0, -1], :] = 0
    interior[:, [0, -1]] = 0
    interior = interior.reshape(-1)
    xx, yy = np.meshgrid(np.linspace(-1, 1, m), np.linspace(-1, 1, m))
    contact = ((xx ** 2 + yy ** 2) < 0.3).reshape(-1)
    m2d = np.where(contact, 1e10, 1.0) * (1.0 + rng.random(N))
    m2d = np.where(interior > 0, m2d, 0.0)
    alpha = 37.0
    free = interior > 0
    diagS = np.where(free, alpha * 4.0 + m2d, 1.0)
    sqinv = 1.0 / np.sqrt(diagS)
    B = np.where(free, sqinv, 0.0).astype(np.float32)
    C = np.where(free, m2d * sqinv * sqinv, 1.0).astype(np.float32)
    w0 = np.where(free, m2d, PIN).astype(np.float32)
    b = np.where(free, rng.standard_normal(N), 0.0).astype(np.float32)
    return alpha, free, B, C, w0, b, np.sqrt(diagS)


def spd_dia_system(n: int, nx: int, seed: int):
    """The random SPD 7-diagonal DIA system of the reference's fused
    DIA-CG golden (tests/test_pallas_ops.py:36), as numpy f64 arrays:
    (offsets, data (7, n), b, the dense solution)."""
    rng = np.random.default_rng(seed)
    offsets = (-nx - 1, -nx, -1, 0, 1, nx, nx + 1)
    sym = {off: k for k, off in enumerate(offsets)}
    data = np.zeros((7, n))
    for k, off in enumerate(offsets):
        if off > 0:
            vals = -rng.random(n) * 0.5
            vals[n - off:] = 0.0
            data[k] = vals
            data[sym[-off]][off:] = vals[:n - off]
    data[sym[0]] = 4.0 + np.abs(data).sum(axis=0)
    A = np.zeros((n, n))
    for k, off in enumerate(offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        A[i, i + off] = data[k][i]
    b = rng.standard_normal(n)
    return offsets, data, b, np.linalg.solve(A, b)


def grids_on(dev, m: int, seed: int):
    """(alpha, b, B, C, whier): the deep-contact state as (m, m) f32
    tensors on dev, with the level diagonals of the V-cycle."""
    from proximalgalerkin_torch.ops import mg
    alpha, _, B, C, w0, b, _ = deep_contact_state(m, seed)

    def g(a):
        return torch.as_tensor(a.reshape(m, m), device=dev)

    ws = mg.w_hierarchy(g(w0), len(mg._levels_for(m)))
    return alpha, g(b), g(B), g(C), ws


def timed(fn, reps: int = 3):
    """Median wall time of fn() in ms, synchronised around each run."""
    times = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def per_call_ms(fn, calls: int = 50, reps: int = 3) -> float:
    """Median over reps runs of the device time per call of fn(), each run
    `calls` calls back to back between two CUDA events (after a warm-up
    call)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return statistics.median(times)


def device_ms(fn, names, calls: int = 50, windows: int = 3) -> dict:
    """Device time per launch in ms of each kernel whose name holds one of
    `names`, from torch.profiler over `calls` calls of fn (after a
    warm-up call). A profiler window that records none of the device's
    activity happens now and then on an H100 (once in a smoke run, just
    after another window had seen every kernel); such a window is taken
    again, up to `windows` in all. Fails if none saw a launch of each."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(windows):
        before = read_counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        hits = {name: [e for e in events
                       if name in e.key and e.device_time_total > 0]
                for name in names}
        if all(sum(e.count for e in h) > 0 for h in hits.values()):
            break
        print(f"  profiler window {attempt + 1} of {windows} saw "
              f"{[n for n, h in hits.items() if not h]} nowhere on the "
              f"device; the port's launches in it: "
              f"{counters_since(before)}", flush=True)
    out = {}
    for name, h in hits.items():
        count = sum(e.count for e in h)
        check(count > 0, f"the profiler saw {name} on the device")
        out[name] = sum(e.device_time_total for e in h) / count / 1e3
    return out


def busy_profile(fn):
    """Runs fn() once under torch.profiler. Returns (fn's result, wall ms,
    device busy ms, {kernel: (device ms, launches)}). Busy time is the
    union of the device intervals the profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        # a window that recorded no device activity at all is taken again
        # (device_ms: it happens now and then on an H100)
        torch.cuda.synchronize()
        before = read_counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
        print(f"  profiler window {attempt + 1} of 3 saw no device "
              f"activity; the port's launches in it: "
              f"{counters_since(before)}", flush=True)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kernel = {e.key: (e.device_time_total / 1e3, e.count)
                 for e in prof.key_averages() if e.device_time_total > 0}
    return out, wall, busy / 1e3, by_kernel


def print_breakdown(title: str, wall: float, busy: float, by_kernel: dict):
    total = sum(ms for ms, _ in by_kernel.values())
    print(f"{title}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {1 - busy / wall:.3f}")
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
        if ms >= 0.005 * total:
            short = name.replace("(anonymous namespace)::", "")
            short = short.split("(")[0].split("<")[0][:40]
            print(f"  {short:40s} {100 * ms / total:5.1f}% {n:7d} launches "
                  f"{1e3 * ms / n:8.2f} us each")


def tail_chain(dev, m: int = 1025) -> dict:
    """The bottom of the V-cycle below its first level in a solve at m (a
    1025 state solves in 29 iterations): the launches a V-cycle between
    the down leg and the up leg of level 1 (at m = 1025: the levels 257
    ... 5, the cluster k_tail, or the grid legs of 257 and 129 around a
    one-block k_tail) and their device time a V-cycle, and k_tail's time
    a launch, from torch.profiler over the priming and live V-cycles (the
    dead iterations after the solve's end are left out)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from proximalgalerkin_torch.ops import mgfused
    alpha, b, B, C, ws = grids_on(dev, m, SEED)
    mgfused.solve(b, B, C, ws, alpha, 1e-6, 500)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, its = mgfused.solve(b, B, C, ws, alpha, 1e-6, 500)
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.time_range.end, k.group(0))
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and (k := re.search(r"\bk_\w+", e.name)))
    cycles, inner = [], None
    for t0, t1, name in kernels:
        if name == "k_down0":
            inner = []
        elif name == "k_up0" and inner is not None:
            cycles.append(inner[1:-1])
            inner = None
        elif inner is not None:
            inner.append((name, t1 - t0))
    cycles = cycles[:its + 1]
    check(len(cycles) == its + 1 and its > 0,
          f"the profiler saw {its + 1} V-cycles at m={m}")
    tails = [us for c in cycles for name, us in c if name == "k_tail"]
    return {"its": its, "launches": len(cycles[0]),
            "chain_us": statistics.mean(sum(us for _, us in c)
                                        for c in cycles),
            "k_tail_us": statistics.mean(tails),
            "kernels": [name for name, _ in cycles[0]]}


def mg_iteration_bytes(m: int) -> int:
    """Bytes one MG-PCG iteration must move: B, C, x, r, p and every
    level's diagonal read once; x, r, p and xb written once (f32)."""
    from proximalgalerkin_torch.ops.mg import _levels_for
    return 4 * (9 * m * m + sum(k * k for k in _levels_for(m)))


def p1_operator(dev, nx: int, ny: int):
    """(offsets, data f64): the DIA stiffness of the P1 obstacle solver on
    the nx x ny-cell rectangle mesh of [-1, 1]^2, on dev."""
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
    mesh = rectangle_mesh(nx, ny, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    dia = P1ObstacleSolver(mesh, device=dev).dia
    return dia.offsets, dia.data


def dia_cg_system(dev, offsets, data, m: int, seed: int,
                  m2d_scale: float = 1.0):
    """(data_eff, b) in f32 on dev: the masked, Jacobi-scaled Schur
    operator of the mixed Jacobi-CG (effective_dia) on the P1 operator
    (offsets, data) at the deep-contact state of the given seed, with its
    m2d (w0 at free rows) times m2d_scale, and its right-hand side.
    m2d_scale = 0 leaves the scaled Laplacian, on which f32 CG runs
    thousands of iterations without reaching its noise floor."""
    from proximalgalerkin_torch.models.obstacle_p1 import effective_dia
    alpha, free, _, _, w0, b, _ = deep_contact_state(m, seed)
    m2d = np.where(free, w0.astype(np.float64), 0.0) * m2d_scale
    sqinv = 1.0 / np.sqrt(np.where(free, 4.0 * alpha + m2d, 1.0))

    def t(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    eff = effective_dia(offsets, data.to(torch.float32), t(free, torch.bool),
                        t(sqinv), t(m2d), float(np.float32(alpha)))
    return eff, t(b)


def residual_ratio(offsets, data, b, x) -> float:
    """|b - A x| / |b|, evaluated in f64."""
    from proximalgalerkin_torch.ops.dia_spmv import dia_spmv_reference
    b64 = b.double()
    r = b64 - dia_spmv_reference(offsets, data.double(), x.double())
    return float(torch.linalg.norm(r) / torch.linalg.norm(b64))


def phase_card():
    print("== phase 1: the card", flush=True)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build():
    print("== phase 2: build", flush=True)
    from concurrent.futures import ThreadPoolExecutor
    from proximalgalerkin_torch.ops import btapply, dia_spmv, ebe, mgfused

    def one(mod):
        t0 = time.time()
        report = mod.build(force=True)
        return time.time() - t0, report

    with ThreadPoolExecutor(4) as ex:
        futs = {name: ex.submit(one, mod)
                for name, mod in (("mgfused", mgfused), ("dia", dia_spmv),
                                  ("ebe", ebe), ("btapply", btapply))}
        done = {name: f.result() for name, f in futs.items()}
    for name, (secs, report) in done.items():
        print(f"build csrc/{name}.cu {secs:.2f} s", flush=True)
        for line in report.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas " + line.strip().split("ptxas info    : ")[-1],
                      flush=True)


def phase_kernel(dev) -> dict:
    print("== phase 3: kernel against plain version", flush=True)
    from proximalgalerkin_torch.ops import mgfused
    m = 1025
    alpha, b, B, C, ws = grids_on(dev, m, SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)

    def rand(shape):
        return torch.randn(shape, generator=gen).to(dev)

    p, t0 = rand((m, m)), rand((m, m))
    err = rel_max(mgfused.kernel_matvec(p, B, C, alpha),
                  mgfused.matvec_reference(p, B, C, alpha))
    print(f"matvec      m={m} max rel diff {err:.3e} (bound 1e-6)")
    check(err <= 1e-6, "matvec")
    beta = 0.375
    err = max(rel_max(u, v) for u, v in zip(
        mgfused.kernel_matvec_update(t0, p, B, C, ws[0], alpha, beta),
        mgfused.matvec_update_reference(t0, p, B, C, ws[0], alpha, beta)))
    print(f"matvec step m={m} (p' = sqf t0 + beta p, S p') max rel diff "
          f"{err:.3e} (bound 1e-6)")
    check(err <= 1e-6, "matvec step")
    f = rand((m, m))
    err = rel_max(mgfused.kernel_down(f, ws[0], alpha),
                  mgfused.down_reference(f, ws[0], alpha))
    print(f"down leg    m={m} max rel diff {err:.3e} (bound 1e-5)")
    check(err <= 1e-5, "down leg")
    mc = (m - 1) // 2 + 1
    e = rand((mc, mc))
    err = rel_max(mgfused.kernel_up(f, ws[0], e, alpha),
                  mgfused.up_reference(f, ws[0], e, alpha))
    print(f"up leg      m={m} max rel diff {err:.3e} (bound 1e-5)")
    check(err <= 1e-5, "up leg")
    ms, lt, nb = mgfused.level_plan(m)
    z = mgfused.kernel_pc(b, B, ws, alpha)
    err = rel_max(z, mgfused.pc_reference(b, B, ws, alpha))
    same = bool(torch.equal(z, mgfused.pc_by_plan_reference(b, B, ws,
                                                              alpha)))
    print(f"V-cycle pc  m={m} levels {ms}, tail from level {lt} on {nb} "
          f"blocks: max rel diff {err:.3e} (bound 1e-5); bitwise equal to "
          f"the plain version split as planned {same}")
    check(err <= 1e-5, "V-cycle")
    check(same, "V-cycle bitwise against the plan")

    tol, maxiter = 1e-6, 500
    ms_k, (xk, itk) = timed(
        lambda: mgfused.solve(b, B, C, ws, alpha, tol, maxiter))
    ms_p, (xp, itp) = timed(
        lambda: mgfused.fused_mg_pcg_reference(b, B, C, ws, alpha, tol,
                                               maxiter))
    xerr = float(torch.linalg.norm(xk - xp) / torch.linalg.norm(xp))
    max_abs = float((xk - xp).abs().max())
    print(f"solve       m={m} its kernel {itk} plain {itp} "
          f"|x-xp|/|xp| {xerr:.3e} max abs {max_abs:.3e} (bounds +-3, 1e-4)")
    check(abs(itk - itp) <= 3 and itk > 0, "solve iterations")
    check(xerr <= 1e-4, "solve x")
    it_bound = mg_iteration_bytes(m) / PEAK_BYTES_PER_S * 1e3
    print(f"time        m={m} kernel solve {ms_k:.3f} ms, plain solve "
          f"{ms_p:.3f} ms (median of 3, {itk} iterations); kernel "
          f"{ms_k / itk:.4f} ms per iteration, bound {it_bound:.4f} ms "
          f"({mg_iteration_bytes(m) / 1e6:.1f} MB at 3.35 TB/s)", flush=True)
    _, wall, busy, by_kernel = busy_profile(
        lambda: mgfused.solve(b, B, C, ws, alpha, tol, maxiter))
    print_breakdown(f"profile     m={m} solve", wall, busy, by_kernel)
    chain = tail_chain(dev, m)
    print(f"tail        m={m} tail from level {lt} on {nb} blocks: k_tail "
          f"{chain['k_tail_us']:.2f} us a launch; below level 1 "
          f"{chain['chain_us']:.2f} us a V-cycle in {chain['launches']} "
          f"launches {chain['kernels']} (the parent's with --ab)",
          flush=True)

    a2, b2, B2, C2, ws2 = grids_on(dev, 257, SEED + 3)
    x64, i64 = mgfused.solve(b2, B2, C2, ws2, a2, tol, maxiter, chunk=64)
    x5, i5 = mgfused.solve(b2, B2, C2, ws2, a2, tol, maxiter, chunk=5)
    x1, i1 = mgfused.solve(b2, B2, C2, ws2, a2, tol, maxiter, chunk=1)
    print(f"chunk 64/5/1 m=257 its {i64}/{i5}/{i1} bitwise equal "
          f"{bool(torch.equal(x64, x5) and torch.equal(x64, x1))}")
    check(i64 == i5 == i1 > 0 and torch.equal(x64, x5)
          and torch.equal(x64, x1), "chunk invariance")
    x0, i0 = mgfused.solve(torch.zeros_like(b), B, C, ws, alpha, tol,
                           maxiter)
    print(f"b = 0       m={m} its {i0} max|x| {float(x0.abs().max())}",
          flush=True)
    check(i0 == 0 and float(x0.abs().max()) == 0.0, "zero rhs")
    _, i7 = mgfused.solve(b2, B2, C2, ws2, a2, 1e-30, 7, chunk=3)
    print(f"maxiter 7   m=257 its {i7}")
    check(i7 == 7, "maxiter")
    # a solve with other alpha and b in the same workspace and graphs,
    # against the same solve in a fresh workspace
    xr, ir = mgfused.solve(b2.flip(0).contiguous(), B2, C2, ws2, 2.5 * a2,
                           tol, maxiter)
    mgfused.release_workspaces()
    xf, i_f = mgfused.solve(b2.flip(0).contiguous(), B2, C2, ws2, 2.5 * a2,
                            tol, maxiter)
    print(f"reuse       m=257 its {ir}/{i_f} bitwise equal to a fresh "
          f"workspace {bool(torch.equal(xr, xf))}", flush=True)
    check(ir == i_f and torch.equal(xr, xf), "workspace reuse")
    return {"max_abs_err": max_abs, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": itk * it_bound, "bound_by": "bytes",
            "library_ms": None}


def csr_of(offsets, data):
    """The DIA operator (offsets, data (ndiag, n)) as a CSR torch.sparse
    tensor holding every in-range diagonal entry."""
    n = int(data.shape[1])
    rows, cols, vals = [], [], []
    i = torch.arange(n, device=data.device)
    for k, off in enumerate(offsets):
        keep = (i + off >= 0) & (i + off < n)
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(data[k][keep])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n, n))
    return coo.coalesce().to_sparse_csr()


def phase_dia_spmv(dev, offsets, data) -> dict:
    print("== phase 4: DIA SpMV kernel against plain version", flush=True)
    from proximalgalerkin_torch.ops.dia_spmv import (dia_spmv,
                                                     dia_spmv_reference)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    n = int(data.shape[1])
    x64 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev)
    timing = {}
    for dt, bound in ((torch.float64, 1e-15), (torch.float32, 1e-6)):
        d, x = data.to(dt), x64.to(dt)
        yk = dia_spmv(offsets, d, x)
        yp = dia_spmv_reference(offsets, d, x)
        err = rel_max(yk, yp)
        ms_k = device_ms(lambda: dia_spmv(offsets, d, x), ["k_spmv"])
        ms_k = ms_k["k_spmv"]
        call_k = per_call_ms(lambda: dia_spmv(offsets, d, x))
        ms_p = per_call_ms(lambda: dia_spmv_reference(offsets, d, x))
        # the yardstick: one CSR product of the same operator
        csr = csr_of(offsets, d)
        err_l = rel_max(csr @ x, yp)
        ms_l = per_call_ms(lambda: csr @ x)
        nbytes = (d.shape[0] + 2) * d.element_size() * n
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        print(f"spmv {str(dt)[6:]} n={n} bitwise {torch.equal(yk, yp)} "
              f"max rel diff {err:.3e} (bound {bound:g}); kernel {ms_k:.4f} "
              f"ms device ({call_k:.4f} ms per call), plain {ms_p:.4f} ms "
              f"per call, CSR torch.sparse {ms_l:.4f} ms per call (nnz "
              f"{csr.values().numel()}, max rel diff {err_l:.1e}) (median "
              f"of 3 runs of 50); bound {bound_ms:.4f} ms "
              f"({nbytes // n} B a row at 3.35 TB/s)", flush=True)
        check(err <= bound, f"spmv {dt}")
        if dt == torch.float64:
            timing = {"max_abs_err": float((yk - yp).abs().max()),
                      "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound_ms,
                      "bound_by": "bytes", "library_ms": ms_l}
        del csr
    # the reference golden's shape: 17 x 13 cells, f32
    offs_s, data_s = p1_operator(dev, 17, 13)
    d = data_s.to(torch.float32)
    x = torch.randn(int(d.shape[1]), generator=gen).to(dev)
    yk, yp = dia_spmv(offs_s, d, x), dia_spmv_reference(offs_s, d, x)
    err = rel_max(yk, yp)
    print(f"spmv float32 17x13 bitwise {torch.equal(yk, yp)} max rel diff "
          f"{err:.3e} (bound 1e-6)", flush=True)
    check(err <= 1e-6, "spmv 17x13")
    return timing


def phase_dia_cg(dev, offsets, data) -> tuple:
    print("== phase 5: fused DIA-CG kernels against plain version",
          flush=True)
    from proximalgalerkin_torch.ops import dia_cg
    f32 = torch.float32

    # the reference golden: random SPD 7-diagonal system, f64
    offs_g, data_g, b_g, x_ref = spd_dia_system(800, 25, SEED)
    dg = torch.as_tensor(data_g, device=dev)
    bg = torch.as_tensor(b_g, device=dev)
    xk, ik = dia_cg.solve(offs_g, dg, bg, 1e-12, 500)
    xp, ip = dia_cg.fused_dia_cg_reference(offs_g, dg, bg, 1e-12, 500)
    ek = np.linalg.norm(xk.cpu().numpy() - x_ref) / np.linalg.norm(x_ref)
    ep = np.linalg.norm(xp.cpu().numpy() - x_ref) / np.linalg.norm(x_ref)
    print(f"golden n=800 f64 its kernel {ik} plain {ip}, |x-x_dense|/"
          f"|x_dense| kernel {ek:.3e} plain {ep:.3e} (bound 1e-9, 0 < its "
          f"< 100), bitwise {torch.equal(xk, xp)}", flush=True)
    check(ek <= 1e-9 and ep <= 1e-9 and 0 < ik < 100 and 0 < ip < 100,
          "golden SPD system")
    check(ik == ip and torch.equal(xk, xp), "golden solve bitwise (f64)")

    # K1 and K2 alone, on the Jacobi-scaled deep-contact operator
    m = int(round(np.sqrt(int(data.shape[1]))))
    eff, b = dia_cg_system(dev, offsets, data, m, SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    p = torch.randn(m * m, generator=gen).to(dev)
    x = torch.randn(m * m, generator=gen).to(dev)
    beta, a = float(np.float32(0.37)), float(np.float32(0.21))
    pn, Ap, _ = k1k = dia_cg.kernel_k1(offsets, eff, b, p, beta)
    k1p = dia_cg.k1_reference(offsets, eff, b, p, beta)
    k2k = dia_cg.kernel_k2(offsets, x, b, pn, Ap, a)
    k2p = dia_cg.k2_reference(x, b, pn, Ap, a)
    ws = dia_cg._workspace(tuple(offsets), b)
    grid, smem = ws.k1_shape()
    print(f"K1 on this card: {grid} blocks, bands of {ws.plan.runs} runs, "
          f"{ws.plan.stages} stages, {smem} B of shared memory a block; "
          f"staged segments {list(zip(ws.plan.start, ws.plan.length))}")
    check(sum(key[1] == m * m for key in dia_cg._workspaces) == 1,
          "K1, K2 and the solves share one workspace")
    timings = []
    for name, outk, outp, fk, fp in (
            ("K1", k1k, k1p,
             lambda: dia_cg.kernel_k1(offsets, eff, b, p, beta),
             lambda: dia_cg.k1_reference(offsets, eff, b, p, beta)),
            ("K2", k2k, k2p,
             lambda: dia_cg.kernel_k2(offsets, x, b, pn, Ap, a),
             lambda: dia_cg.k2_reference(x, b, pn, Ap, a))):
        err = max(rel_max(u, v) for u, v in zip(outk, outp))
        bitwise = all(torch.equal(u, v) for u, v in zip(outk, outp))
        call_k, ms_p = per_call_ms(fk), per_call_ms(fp)
        print(f"{name} m={m} bitwise {bitwise} max rel diff {err:.3e} "
              f"(bound 1e-6); wrapper call {call_k:.4f} ms (with its copies "
              f"into the workspace), plain {ms_p:.4f} ms per call (median "
              "of 3 runs of 50)", flush=True)
        check(bitwise and err <= 1e-6, name)
        # bytes a row: K1 reads 7 diagonals, r and p and writes p' and
        # Ap; K2 reads x, p', r and Ap and writes x and r (f32)
        row_bytes = {"K1": 44, "K2": 24}[name]
        timings.append({"max_abs_err": max(float((u - v).abs().max())
                                           for u, v in zip(outk, outp)),
                        "plain_ms": ms_p,
                        "bound_ms": row_bytes * m * m / PEAK_BYTES_PER_S
                        * 1e3, "bound_by": "bytes", "library_ms": None})

    # whole solves at tol 1e-5
    tol, maxiter = 1e-5, 40 * m
    ms_k, (xk, ik) = timed(lambda: dia_cg.solve(offsets, eff, b, tol,
                                                maxiter))
    ms_p, (xp, ip) = timed(lambda: dia_cg.fused_dia_cg_reference(
        offsets, eff, b, tol, maxiter))
    rk = residual_ratio(offsets, eff, b, xk)
    rp = residual_ratio(offsets, eff, b, xp)
    dx = float(torch.linalg.norm(xk - xp) / torch.linalg.norm(xp))
    print(f"solve m={m} tol {tol:g} its kernel {ik} plain {ip} (equal), "
          f"|b-Sx|/|b| kernel {rk:.3e} plain {rp:.3e} (bound "
          f"{1.5 * tol:g}), |x-xp|/|xp| {dx:.3e}, bitwise "
          f"{torch.equal(xk, xp)}; kernel {ms_k:.3f} ms, plain {ms_p:.3f} "
          "ms (median of 3)", flush=True)
    check(ik > 0 and ik == ip and torch.equal(xk, xp), "solve bitwise")
    check(rk <= 1.5 * tol and rp <= 1.5 * tol, "solve residual")

    # time per iteration over a fixed 2,000 iterations, on the scaled
    # Laplacian (the deep-contact system reaches f32 underflow sooner)
    its = 2000
    effl, bl = dia_cg_system(dev, offsets, data, m, SEED, m2d_scale=0.0)
    replays = dia_cg.solve.replays
    ms_k, (xk, ik) = timed(lambda: dia_cg.solve(
        offsets, effl, bl, 1e-30, its, stall_guard=0.0))
    replays = (dia_cg.solve.replays - replays) // 3
    ms_p, (xp, ip) = timed(lambda: dia_cg.fused_dia_cg_reference(
        offsets, effl, bl, 1e-30, its, stall_guard=0.0), reps=1)
    print(f"per iteration m={m}: kernel {ms_k / ik:.4f} ms ({ik} its, "
          f"median of 3; {replays} graph replays a solve), plain "
          f"{ms_p / ip:.4f} ms ({ip} its, one run), bitwise "
          f"{torch.equal(xk, xp)}", flush=True)
    check(ik == ip == its and torch.equal(xk, xp), "2,000 iterations")
    check(replays == -(-its // 64), "one graph replay per chunk")
    # the kernels of a solve as the profiler sees them, and device time
    # per launch of the two of an iteration
    _, wall, busy, by_kernel = busy_profile(lambda: dia_cg.solve(
        offsets, effl, bl, 1e-30, 256, stall_guard=0.0))
    print_breakdown(f"profile m={m} 256 iterations", wall, busy, by_kernel)
    ours = sorted({k.replace("(anonymous namespace)::", "").split("<")[0]
                   .split()[-1] for k in by_kernel if "anonymous" in k})
    print(f"kernels of the solve: {ours}")
    check(ours == ["k_k1", "k_k2", "k_prime"],
          "an iteration is K1 and K2 (and one priming launch a solve)")
    names = ["k_k1", "k_k2"]
    dev_ms = device_ms(lambda: dia_cg.solve(
        offsets, effl, bl, 1e-30, 256, stall_guard=0.0), names, calls=4)
    busy = sum(dev_ms.values())
    print("device ms per launch in the solve: " + ", ".join(
        f"{k} {v:.4f}" for k, v in dev_ms.items()) + f"; one iteration's "
        f"kernels {busy:.4f} ms of {ms_k / ik:.4f} ms (busy share "
        f"{busy / (ms_k / ik):.3f}); bounds K1 "
        f"{timings[0]['bound_ms']:.4f} ms, K2 {timings[1]['bound_ms']:.4f} "
        "ms", flush=True)
    timings[0]["ms"], timings[1]["ms"] = dev_ms["k_k1"], dev_ms["k_k2"]
    del effl

    # chunk invariance, zero right-hand side, maxiter
    offs2, data2 = p1_operator(dev, 256, 256)
    eff2, b2 = dia_cg_system(dev, offs2, data2, 257, SEED + 3)
    x64, i64 = dia_cg.solve(offs2, eff2, b2, tol, maxiter, chunk=64)
    x5, i5 = dia_cg.solve(offs2, eff2, b2, tol, maxiter, chunk=5)
    x1, i1 = dia_cg.solve(offs2, eff2, b2, tol, maxiter, chunk=1)
    print(f"chunk 64/5/1 m=257 its {i64}/{i5}/{i1} bitwise equal "
          f"{bool(torch.equal(x64, x5) and torch.equal(x64, x1))}")
    check(i64 == i5 == i1 > 0 and torch.equal(x64, x5)
          and torch.equal(x64, x1), "chunk invariance")
    # two solves with other matrices and right-hand sides in one
    # workspace and its graphs, against the same solves in fresh ones
    eff3, b3 = dia_cg_system(dev, offs2, data2, 257, SEED + 5,
                             m2d_scale=0.5)
    xr, ir = dia_cg.solve(offs2, eff3, b3, tol, maxiter)
    fresh = []
    for e_, b_ in ((eff2, b2), (eff3, b3)):
        dia_cg.release_workspaces()
        fresh.append(dia_cg.solve(offs2, e_, b_, tol, maxiter))
    same = (fresh[0][1] == i64 and torch.equal(fresh[0][0], x64)
            and fresh[1][1] == ir and torch.equal(fresh[1][0], xr))
    print(f"reuse       m=257 its {i64}, {ir} / fresh {fresh[0][1]}, "
          f"{fresh[1][1]} bitwise equal to fresh workspaces {same}",
          flush=True)
    check(same and ir > 0, "workspace reuse")
    x0, i0 = dia_cg.solve(offsets, eff, torch.zeros_like(b), tol, maxiter)
    print(f"b = 0       m={m} its {i0} max|x| {float(x0.abs().max())}")
    check(i0 == 0 and float(x0.abs().max()) == 0.0, "zero rhs")
    _, i7 = dia_cg.solve(offsets, eff, b, 1e-30, 7, stall_guard=0.0,
                         chunk=3)
    print(f"maxiter 7   m={m} its {i7}", flush=True)
    check(i7 == 7, "maxiter")
    del eff, eff2, eff3
    return timings[0], timings[1]


def reset_counters():
    from proximalgalerkin_torch.ops import (btapply, dia_cg, dia_spmv, ebe,
                                            mgfused)
    mgfused.solve.launches = 0
    dia_spmv.dia_spmv.launches = 0
    dia_cg.solve.launches = 0
    dia_cg.solve.replays = 0
    ebe.ebe_apply.launches = 0
    btapply.bt_apply.launches = 0


def read_counters() -> dict:
    from proximalgalerkin_torch.ops import (btapply, dia_cg, dia_spmv, ebe,
                                            mgfused)
    return {"fused_mg_pcg": mgfused.solve.launches,
            "dia_spmv": dia_spmv.dia_spmv.launches,
            "dia_cg": dia_cg.solve.launches,
            "dia_cg_replays": dia_cg.solve.replays,
            "ebe": ebe.ebe_apply.launches,
            "bt_apply": btapply.bt_apply.launches}


def check_launches(launches: dict, what: str, uses=()):
    """The port's kernels named in `uses` launched, and no other."""
    for name, n in launches.items():
        if name in uses:
            check(n > 0, f"{what} launches {name}")
        else:
            check(n == 0, f"{what} launches no {name}")


def counters_since(before: dict) -> dict:
    """The port's launches since read_counters() gave `before`."""
    return {k: v - before[k] for k, v in read_counters().items()}


class InnerTimer:
    """Inside the with block, every solve call of the P1 solver's inner
    kernel module (`name`: mgfused or dia_cg) is timed (synchronised
    before and after) and its iterations summed."""

    def __init__(self, name: str):
        self.name = name
        self.ms, self.its, self.calls = 0.0, 0, 0

    def __enter__(self):
        from proximalgalerkin_torch.models import obstacle_p1
        real, timer = getattr(obstacle_p1, self.name), self

        class Shim:
            @staticmethod
            def solve(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, its = real.solve(*args, **kwargs)
                torch.cuda.synchronize()
                timer.ms += (time.perf_counter() - t0) * 1e3
                timer.its += its
                timer.calls += 1
                return x, its

        self._module, self._real = obstacle_p1, real
        setattr(obstacle_p1, self.name, Shim)
        return self

    def __exit__(self, *exc):
        setattr(self._module, self.name, self._real)


# The 1024^2 solves' outer, Newton and CG counts and the SHA-256 prefix of
# u, as every H100 run of these kernels has read them (PERF.md)
MAIN_PATH_PINS = {"mg": (25, 45, 29467, "466bb3544c74f91e"),
                  "jacobi": (26, 46, 176066, "bdcf4d10db6b4971")}


def chunk_graphs() -> int:
    """The CUDA graphs of the MG-PCG and DIA-CG chunks captured so far."""
    from proximalgalerkin_torch.ops import dia_cg, mgfused
    return sum(len(ws.graphs) for mod in (mgfused, dia_cg)
               for ws in mod._workspaces.values())


def drive_main(dev, pc: str, n: int = 1024, inner=None):
    """The 32^2 card-vs-CPU check, then the n^2 solve with pc; returns
    (the solver, its result, the launch counts of the n^2 solve). inner:
    a context entered around the n^2 solve alone."""
    import contextlib
    from proximalgalerkin_torch import cli
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
    kw = dict(alpha_cap=1e2, outer_tol=1e-8, mixed_precision=True, pc=pc)

    # the repo's own check (the reference's fused-vs-plain trajectory
    # test): the kernel path on the card against the plain path on the
    # CPU, at 32^2
    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    r_c = P1ObstacleSolver(mesh, device=dev, **kw).solve(max_outer=6)
    r_h = P1ObstacleSolver(mesh, device="cpu", **kw).solve(max_outer=6)
    du = float(np.abs(r_c.u - r_h.u).max())
    print(f"32^2 card vs cpu: newton {r_c.newton_per_outer} vs "
          f"{r_h.newton_per_outer}, cg {r_c.cg_its_total} vs "
          f"{r_h.cg_its_total}, max|du| {du:.3e} (atol 5e-9)")
    check(r_c.newton_per_outer == r_h.newton_per_outer,
          "32^2 Newton trajectory")
    check(bool(np.allclose(r_c.u, r_h.u, atol=5e-9)), "32^2 u")

    t0 = time.time()
    mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    solver = P1ObstacleSolver(mesh, device=dev, **kw)
    torch.cuda.synchronize()
    setup = time.time() - t0
    # the bench's warm-up (cli.run_bench): the timed solve captures no
    # chunk graph
    t0 = time.time()
    cli.warmup_newton(solver)
    warmup = time.time() - t0
    graphs = chunk_graphs()
    reset_counters()
    t0 = time.time()
    with inner or contextlib.nullcontext():
        res = solver.solve()
        torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = read_counters()
    feas = float((res.u - solver.phi.cpu().numpy()).min())
    sha = hashlib.sha256(res.u.tobytes()).hexdigest()[:16]
    print(f"{n}^2 pc={pc} dofs {2 * solver.N} setup {setup:.2f} s warm-up "
          f"{warmup:.2f} s solve {elapsed:.2f} s outer "
          f"{res.outer_iterations} newton {res.newton_its} cg "
          f"{res.cg_its_total} feasibility {feas:.3e} launches {counts}; "
          f"chunk graphs {graphs} before the solve, {chunk_graphs()} after")
    print(f"newton_per_outer {res.newton_per_outer}; SHA-256 of u {sha}",
          flush=True)
    check(chunk_graphs() == graphs and graphs > 0,
          "the timed solve captures no chunk graph")
    if n == 1024:
        got = (res.outer_iterations, res.newton_its, res.cg_its_total, sha)
        check(got == MAIN_PATH_PINS[pc],
              f"{n}^2 pc={pc} outer, Newton, CG and u {got} equal "
              f"{MAIN_PATH_PINS[pc]}")
    check(res.converged, f"{n}^2 converged")
    check(res.u.shape == (solver.N,) and bool(np.isfinite(res.u).all()),
          "u finite, of shape (N,)")
    check(feas >= -1e-10, "feasibility")
    check(counts["dia_spmv"] > 0, "DIA SpMV kernel launched")
    return solver, res, counts


# the first MG-PCG kernel's numbers as PERF.md records them (one H100
# 80GB HBM3 at 700 W): ms per CG iteration, idle share over outer step 1
FIRST_KERNEL_MS_PER_IT, FIRST_KERNEL_IDLE_OUTER1 = 0.1884, 0.35
# and this port's first DIA-CG (four launches an iteration), likewise
FIRST_DIA_CG_MS_PER_IT, FIRST_DIA_CG_IDLE_OUTER1 = 0.0519, 0.20


def phase_main_mg(dev, n: int = 1024):
    print("== phase 6: main path, mixed + mg", flush=True)
    inner = InnerTimer("mgfused")
    solver, res, counts = drive_main(dev, "mg", n, inner)
    check(counts["fused_mg_pcg"] > 0, "MG-PCG kernel launched")
    check(inner.its == res.cg_its_total, "every CG iteration timed")
    print(f"{n}^2 mg inner solves: {inner.calls} solves, {inner.ms:.1f} ms "
          f"of the solve, {inner.ms / inner.its:.4f} ms per CG iteration "
          f"(bound {mg_iteration_bytes(n + 1) / PEAK_BYTES_PER_S * 1e3:.4f}"
          f" ms; the first kernel {FIRST_KERNEL_MS_PER_IT} ms, recorded)",
          flush=True)
    res1, wall, busy, by_kernel = busy_profile(
        lambda: solver.solve(max_outer=1))
    print_breakdown(f"{n}^2 mg outer step 1 ({res1.newton_its} Newton, "
                    f"{res1.cg_its_total} CG)", wall, busy, by_kernel)
    print(f"(the first kernel: idle share {FIRST_KERNEL_IDLE_OUTER1} over "
          "outer step 1, recorded)", flush=True)
    return res.u, counts


def phase_main_jacobi(dev, u_mg, n: int = 1024):
    print("== phase 7: main path, mixed + jacobi", flush=True)
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
    inner = InnerTimer("dia_cg")
    solver, res, counts = drive_main(dev, "jacobi", n, inner)
    replays = counts["dia_cg_replays"]
    rel = float(np.linalg.norm(res.u - u_mg) / np.linalg.norm(u_mg))
    print(f"{n}^2 |u_jacobi - u_mg|/|u_mg| {rel:.3e} (bound 1e-6)",
          flush=True)
    check(counts["dia_cg"] > 0, "DIA-CG kernels launched")
    check(rel <= 1e-6, "jacobi and mg solutions agree")
    check(inner.its == res.cg_its_total, "every CG iteration timed")
    check(replays * 64 == counts["dia_cg"], "one graph replay per chunk")
    print(f"{n}^2 jacobi inner solves: {inner.calls} solves, {replays} "
          f"graph replays, {inner.ms:.1f} ms of the solve, "
          f"{inner.ms / inner.its:.4f} ms per CG iteration (bounds of K1 "
          f"and K2 together {68 * (n + 1) ** 2 / PEAK_BYTES_PER_S * 1e3:.4f}"
          f" ms; this port's first DIA-CG {FIRST_DIA_CG_MS_PER_IT} ms, "
          "recorded)", flush=True)
    res1, wall, busy, by_kernel = busy_profile(
        lambda: solver.solve(max_outer=1))
    print_breakdown(f"{n}^2 jacobi outer step 1 ({res1.newton_its} Newton, "
                    f"{res1.cg_its_total} CG)", wall, busy, by_kernel)
    print(f"(this port's first DIA-CG: idle share {FIRST_DIA_CG_IDLE_OUTER1} "
          "over outer step 1, recorded)", flush=True)

    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    s = P1ObstacleSolver(mesh, device=dev, alpha_cap=1e2, outer_tol=1e-8,
                         mixed_precision=True, pc="jacobi")
    a, b = s.solve(), s.solve_fused()
    du = float(np.abs(a.u - b.u).max())
    print(f"32^2 solve_fused vs solve: outer {b.outer_iterations}/"
          f"{a.outer_iterations} newton {b.newton_its}/{a.newton_its} "
          f"max|du| {du}", flush=True)
    check(a.converged and b.converged and du == 0.0
          and b.outer_iterations == a.outer_iterations
          and b.newton_its == a.newton_its, "solve_fused is solve")
    return counts


# Sizes of phases 8 and 9, chosen once from a measurement on one H100
# (PERF.md, section 6): the bench's FD grid, N = 1025 (2,101,250 dofs);
# and a 160^2 mesh (51,842 dofs) for the general stack, since at 224^2
# (the distributed obstacle record's 101,250 dofs) (a) and (b) together
# took 121.9 s, over the 120 s set for them, and 160^2 took 60.3 s
FD_N = 1025
LVPP_N = 160


def fd_iteration_bytes(N: int) -> int:
    """Bytes one FD Schur-CG iteration must move (f64): x, r and p read
    and written, the scaling sD and the latent diagonal read, the free
    mask (1 byte) read."""
    return N * N * (6 * 8 + 2 * 8 + 1)


def phase_fd(dev, N: int = FD_N):
    print("== phase 8: FD obstacle (models/obstacle_fd.py)", flush=True)
    from proximalgalerkin_torch.core.logging import counter
    from proximalgalerkin_torch.models.obstacle_fd import fd_obstacle_solve
    kw = dict(outer_tol=1e-8, alpha_cap=1e2)
    # the card against the port's own CPU run of the same code, at N = 65
    r_c = fd_obstacle_solve(65, device=dev, **kw)
    r_h = fd_obstacle_solve(65, device="cpu", **kw)
    du = float(np.abs(r_c.u - r_h.u).max())
    print(f"N=65 card vs cpu: newton_per_outer {r_c.newton_per_outer} vs "
          f"{r_h.newton_per_outer}, cg {r_c.cg_its} vs {r_h.cg_its}, "
          f"max|du| {du:.3e} (bound 1e-10)", flush=True)
    check(r_c.newton_per_outer == r_h.newton_per_outer, "N=65 Newton counts")
    check(du <= 1e-10, "N=65 u")

    reset_counters()
    reads = counter("host_reads")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fd_obstacle_solve(N, device=dev, **kw)
    elapsed = time.perf_counter() - t0
    reads = counter("host_reads") - reads
    counts = read_counters()
    feas = float((res.u - res.phi).min())
    ms_it = elapsed * 1e3 / max(res.cg_its, 1)
    bound = fd_iteration_bytes(N) / PEAK_BYTES_PER_S * 1e3
    print(f"N={N} dofs {2 * N * N}: outer {res.outer_iterations} newton "
          f"{res.newton_its} newton_per_outer {res.newton_per_outer} cg "
          f"{res.cg_its} solve {elapsed:.2f} s, {ms_it:.4f} ms per CG "
          f"iteration (bound {bound:.4f} ms), feasibility min(u - phi) {feas:.3e}, host reads "
          f"{reads}, launches of the port's CUDA kernels {counts}",
          flush=True)
    check(res.outer_iterations < 100, f"N={N} converged")
    check(bool(np.isfinite(res.u).all()) and res.u.shape == (N, N),
          "u finite, of shape (N, N)")
    check(feas >= -1e-10, "feasibility")
    # the profiled window is the first Newton step of outer step 1: the
    # profiler's own processing of a window takes about 4 s a Newton step
    r1, wall, busy, by_kernel = busy_profile(
        lambda: fd_obstacle_solve(N, device=dev, max_outer=1, newton_max=1,
                                  **kw))
    print_breakdown(f"N={N} outer step 1, Newton step 1 ({r1.cg_its} CG)",
                    wall, busy, by_kernel)
    launches = sum(n for _, n in by_kernel.values())
    print(f"N={N} outer step 1, Newton step 1: "
          f"{launches / max(r1.cg_its, 1):.1f} kernel launches per CG "
          "iteration", flush=True)
    return res


class MinresTally:
    """Inside the with block, every krylov.minres call sums its iteration
    count (on the device) and is timed, synchronised before and after."""

    def __enter__(self):
        from proximalgalerkin_torch.la import krylov
        real, tally = krylov.minres, self
        self.its, self.calls, self.ms = 0, 0, 0.0

        def minres(A, b, x0=None, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, _, its = krylov.minres_info(A, b, x0, **kw)
            torch.cuda.synchronize()
            tally.ms += (time.perf_counter() - t0) * 1e3
            tally.its += int(its)
            tally.calls += 1
            return x

        self._module, self._real = krylov, real
        krylov.minres = minres
        return self

    def __exit__(self, *exc):
        self._module.minres = self._real


def phase_lvpp(dev, n: int = LVPP_N):
    print("== phase 9: general LVPP stack (models/obstacle.py)", flush=True)
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    kw = dict(polynomial_order=1, alpha_scheme="double_exponential",
              alpha_max=1e2, tol_exit=1e-6, verbose=False, device=dev)

    # (a) the reference's default direction: element matrices on the
    # card, SuperLU on the host
    t0 = time.perf_counter()
    prob = setup_obstacle_problem(mesh, **kw)
    setup = time.perf_counter() - t0
    first_two = []
    obs = prob.solver.observables
    obs["x"] = lambda x, x_k, a: (
        first_two.append(x.clone()) if len(first_two) < 2 else None) or 0.0
    reset_counters()
    t0 = time.perf_counter()
    res = prob.solve()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    del obs["x"], res.observables["x"]
    counts = read_counters()
    u = prob.u(res)
    last = {k: v[-1] for k, v in res.observables.items()}
    print(f"{n}^2 P1 dofs {prob.space.num_dofs} (a) preonly/lu: setup "
          f"{setup:.2f} s, solve {elapsed:.2f} s, outer {res.iterations} "
          f"newton {res.total_newton} newton_steps {res.newton_steps} "
          f"converged {res.converged}; launches of the port's CUDA kernels "
          f"{counts}", flush=True)
    print(f"last step observables {json.dumps(last)}", flush=True)
    print("PhaseTimer (a):\n  " + prob.solver.timer.report().replace(
        "\n", "\n  "), flush=True)
    check(res.converged, f"{n}^2 LVPP converged")
    check(bool(np.isfinite(u).all()), "u finite")
    phi = prob.V.dof_points.T
    from proximalgalerkin_torch.models.obstacle import spherical_cap_obstacle
    print(f"min(u - phi) {float((u - spherical_cap_obstacle(phi)).min()):.3e}",
          flush=True)

    # (b) the first two outer steps with the device-resident direction of
    # the reference CLI's device protocol
    opts = {"ksp_type": "minres", "pc_type": "jacobi", "mat_type": "ell",
            "ksp_rtol": 1e-11, "ksp_max_it": 4000}
    prob_b = setup_obstacle_problem(
        mesh, maximum_number_of_outer_loop_iterations=2,
        solver_options=opts, **kw)
    t0 = time.perf_counter()
    with MinresTally() as tally:
        res_b = prob_b.solve()
        torch.cuda.synchronize()
    elapsed_b = time.perf_counter() - t0
    dx = float((res_b.x - first_two[1]).abs().max())
    print(f"{n}^2 (b) minres/jacobi/ell, first two outer steps: solve "
          f"{elapsed_b:.2f} s, newton_steps {res_b.newton_steps} against "
          f"(a) {res.newton_steps[:2]}, MINRES {tally.its} iterations in "
          f"{tally.calls} solves, {tally.ms:.1f} ms "
          f"({tally.ms / max(tally.its, 1):.4f} ms per iteration), "
          f"max|x_b - x_a| {dx:.3e} (bound 1e-8)", flush=True)
    print("PhaseTimer (b):\n  " + prob_b.solver.timer.report().replace(
        "\n", "\n  "), flush=True)
    check(res_b.newton_steps == res.newton_steps[:2], "(b) Newton counts")
    check(dx <= 1e-8, "(b) x")
    return res, elapsed, prob.solver.timer


# Phase 10: the LVPP example models (models/obstacle_spectral.py,
# intersecting.py, eigenvalue_constraints.py, thermoforming.py,
# thermoforming_compare.py, gradient_constraint.py, fracture.py).
MODELS = ("obstacle_spectral", "intersecting", "eigenvalue", "thermoforming",
          "thermoforming_compare", "gradient_constraint", "fracture")
SPECTRAL_PS = (8, 16, 24, 32, 40, 48)
# The JAX package's counts at each model's record size (RESULTS.md:159-171,
# sizes below), from runs of the reference on the CPU with the models'
# default options; the port's CPU runs give the same. Spectral p >= 32:
# the port's CPU counts (the reference's CPU dense f64 loop takes minutes a
# Newton step there; it agrees with the port up to p = 24).
REFERENCE_COUNTS = {
    "obstacle_spectral": {"f64": [28, 110, 109, 109, 107, 107],
                          "f32_refine": [28, 110, 109, 109, 107, 107]},
    "intersecting": {"lvpp": [7, 12, 3, 3, 3, 3],
                     "newton": [37, 49, 5, 5, 5, 5]},
    "eigenvalue": {"lvpp": 7, "newton": [6, 3, 2, 2, 2, 1, 1]},
    "thermoforming": {"lvpp": 46, "newton": [
        6, 4, 5, 11, 6, 2, 1, 1, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 12, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 19, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1]},
    "thermoforming_compare": {"moreau_yosida": [12, 104],
                              "fixed_point": [16, 323],
                              "semismooth": [66, 66]},
    "gradient_constraint": {"lvpp": 19, "newton": [
        5, 6, 4, 4, 4, 3, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1]},
    "fracture": {"newton": [37, 30, 27, 25, 20, 20, 18, 16, 15, 67, 362, 93,
                            32, 8, 26, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
                            8],
                 "lvpp": [12, 12, 12, 11, 9, 9, 8, 8, 7, 13, 24, 15, 6, 2, 5,
                          2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
                 "retries": [0] * 10 + [5] + [0] * 18, "broken": False},
}


# Bound of phase 10 (i) and of the gpu test on max |card - cpu| / max |cpu|
# of each field: 1e-10, except thermoforming's 1e-7, whose Newton solves
# stop at an absolute residual of 1e-5 after one step each at the capped
# alpha, which fixes its iterate only to about 1e-9 (1.7e-9 to 5.4e-9 in
# three runs on an H100 at M = 24, with every count equal)
FIELD_RTOL = {"thermoforming": 1e-7}


def field_rtol(name: str) -> float:
    return FIELD_RTOL.get(name, 1e-10)


def rel_field(a, b) -> float:
    """max |a - b| / max |b| of two host arrays."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def model_case(name: str, dev):
    """The smallest case of the model's CPU parity test
    (tests/test_torch_<model>.py) on dev: (counts, fields as host
    arrays)."""
    from proximalgalerkin_torch.models import (eigenvalue_constraints,
                                               fracture, gradient_constraint,
                                               intersecting, obstacle_spectral,
                                               thermoforming,
                                               thermoforming_compare)
    if name == "obstacle_spectral":
        counts, fields = {}, {}
        for dt in ("f64", "f32_refine"):
            cu, its, _ = obstacle_spectral.spectral_obstacle_solve(
                8, solve_dtype=dt, device=dev)
            counts[dt], fields["cu_" + dt] = its, cu
        return counts, fields
    if name == "intersecting":
        r = intersecting.solve_intersecting(
            n_cells=201, phis=(3.0, 1.0, 0.1), verbose=False, device=dev)
        return ({"lvpp": r.lvpp_iterations, "newton": r.newton_iterations,
                 "converged": r.converged}, {"u": r.u})
    if name == "eigenvalue":
        r = eigenvalue_constraints.solve_eigenvalue_constraints(
            N=10, degree=2, quadrature_degree=8, tol=1e-8, verbose=False,
            device=dev)
        return ({"lvpp": r.lvpp.iterations, "newton": r.lvpp.newton_steps},
                {"q1": r.q1, "q2": r.q2})
    if name == "thermoforming":
        r = thermoforming.solve_thermoforming(
            M=24, verbose=False, termination_tol=1e-7, device=dev)
        return ({"lvpp": r.lvpp_iterations, "newton": r.newton_iterations},
                {"u": r.u, "T": r.T, "psi": r.psi})
    if name == "thermoforming_compare":
        counts, fields = {}, {}
        for fn, kw in (("moreau_yosida_solve", {"max_outer": 15}),
                       ("fixed_point_solve", {}),
                       ("semismooth_active_set_solve", {})):
            b = getattr(thermoforming_compare, fn)(M=20, verbose=False,
                                                   device=dev, **kw)
            counts[fn] = [b.outer_iterations, b.linear_solves, b.converged]
            fields[fn + ".u"], fields[fn + ".T"] = b.u, b.T
        return counts, fields
    if name == "gradient_constraint":
        prob, r = gradient_constraint.solve_gradient_constraint(
            N=8, M=8, primal_degree=1, max_iterations=30, stopping_tol=1e-6,
            verbose=False, quadrature_degree=4, device=dev)
        return ({"lvpp": r.iterations, "newton": r.newton_steps},
                {"u": prob.u(r), "psi": prob.psi(r)})
    if name == "fracture":
        r = fracture.solve_fracture(max_res=0.4, Tmax=0.6, num_load_steps=4,
                                    verbose=False, device=dev)
        return ({"newton": r.newton_per_step, "lvpp": r.lvpp_per_step,
                 "retries": r.retries_per_step, "broken": r.broken},
                {"u": r.u, "c": r.c})
    raise ValueError(name)


def model_record(name: str, dev, timer):
    """The model at its record size on dev, its Newton solvers adding to
    `timer`: (counts comparable with REFERENCE_COUNTS[name], [(check,
    passed)], lines to print)."""
    from proximalgalerkin_torch.models import (eigenvalue_constraints,
                                               fracture, gradient_constraint,
                                               intersecting, obstacle_spectral,
                                               thermoforming,
                                               thermoforming_compare)
    if name == "obstacle_spectral":
        sweeps = {dt: obstacle_spectral.spectral_p_sweep(
            ps=SPECTRAL_PS, solve_dtype=dt, device=dev)
            for dt in ("f64", "f32_refine")}
        a, b = sweeps["f64"], sweeps["f32_refine"]
        dsup = max(abs(x - y) for x, y in zip(a.sup_errors[1:],
                                              b.sup_errors[1:]))
        lines = [f"  {dt} p {list(SPECTRAL_PS)}: sup diffs "
                 f"{[float(f'{v:.6g}') for v in s.sup_errors]}; phases "
                 f"{s.phases}" for dt, s in sweeps.items()]
        return ({dt: s.newton_its for dt, s in sweeps.items()},
                [("f32_refine Newton counts equal f64's",
                  a.newton_its == b.newton_its),
                 (f"sup-differences agree within 1e-8 ({dsup:.2e})",
                  dsup < 1e-8)], lines)
    if name == "intersecting":
        from proximalgalerkin_torch.models.intersecting import smooth_bump
        r = intersecting.solve_intersecting(n_cells=1001, verbose=False,
                                            device=dev, timer=timer)
        xs = np.linspace(0, 1, 1002)
        low = float((r.u - smooth_bump(xs)).min())
        du = np.diff(r.u) / (xs[1] - xs[0])
        mask = (xs[:-1] < 0.19) | (xs[:-1] > 0.81)
        dmax = float(np.abs(du[mask]).max())
        return ({"lvpp": r.lvpp_iterations, "newton": r.newton_iterations},
                [("all continuation steps converged", all(r.converged)),
                 (f"u - bump > -1e-3 ({low:.3e})", low > -1e-3),
                 (f"|u'| < 0.105 outside the window ({dmax:.4f})",
                  dmax < 0.105)], [])
    if name == "eigenvalue":
        r = eigenvalue_constraints.solve_eigenvalue_constraints(
            N=20, degree=3, tol=1e-10, verbose=False, device=dev, timer=timer)
        lo, hi = r.eigenvalue_range()
        return ({"lvpp": r.lvpp.iterations, "newton": r.lvpp.newton_steps},
                [("converged", r.lvpp.converged),
                 (f"eigenvalue range [{lo!r}, {hi!r}] within [-0.5 - 1e-8, "
                  "0.5 + 1e-8], hi > 0.45",
                  lo >= -0.5 - 1e-8 and 0.45 < hi <= 0.5 + 1e-8)], [])
    if name == "thermoforming":
        r = thermoforming.solve_thermoforming(
            M=48, max_lvpp_iterations=THERMOFORMING_HELD_STEPS,
            verbose=False, device=dev, timer=timer)
        viol = float((r.u - r.mould).max())
        return ({"lvpp": r.lvpp_iterations, "newton": r.newton_iterations},
                [(f"max(u - mould) < 0.02 ({viol:.3e})", viol < 0.02),
                 (f"0 < T < 25 ([{r.T.min():.4f}, {r.T.max():.4f}])",
                  0.0 < r.T.min() and r.T.max() < 25.0)],
                [f"  total Newton {r.total_newton}"])
    if name == "thermoforming_compare":
        counts, checks = {}, []
        for key, fn in (("moreau_yosida", "moreau_yosida_solve"),
                        ("fixed_point", "fixed_point_solve"),
                        ("semismooth", "semismooth_active_set_solve")):
            b = getattr(thermoforming_compare, fn)(M=48, verbose=False,
                                                   device=dev, timer=timer)
            counts[key] = [b.outer_iterations, b.linear_solves]
            checks.append((f"{key} converged", b.converged))
        return counts, checks, []
    if name == "gradient_constraint":
        prob, r = gradient_constraint.solve_gradient_constraint(
            N=48, M=48, primal_degree=2, alpha_scheme="doubling",
            stopping_tol=1e-8, verbose=False, device=dev, timer=timer)
        form = prob.form
        _, grads = form._eval_field("u", r.x, form.cell_data)
        gn = np.linalg.norm(grads[:, :, 0, :].cpu().numpy(), axis=-1)
        xq = form.xq.cpu().numpy()
        phi_q = gradient_constraint.default_phi(
            xq.reshape(-1, 2).T).reshape(gn.shape)
        viol = float(np.maximum(gn - phi_q, 0.0).mean())
        return ({"lvpp": r.iterations, "newton": r.newton_steps},
                [("converged", r.converged),
                 (f"mean positive violation of |grad u| <= phi < 0.01 "
                  f"({viol:.3e})", viol < 0.01)],
                [f"  total Newton {r.total_newton}"])
    if name == "fracture":
        # the record's loads are linspace(0, 3, 30)[1:]; these are its
        # first FRACTURE_LOAD_STEPS, bit for bit
        k = FRACTURE_LOAD_STEPS
        r = fracture.solve_fracture(
            max_res=0.1, Tmin=0.0, Tmax=float(np.linspace(0.0, 3.0, 30)[k]),
            num_load_steps=k + 1, verbose=False, device=dev, timer=timer)
        d = r.max_damage_history
        mono = all(d[i + 1] >= d[i] - 2e-2 for i in range(len(d) - 1))
        return ({"newton": r.newton_per_step, "lvpp": r.lvpp_per_step,
                 "retries": r.retries_per_step, "broken": r.broken},
                [("max damage monotone within 2e-2", mono),
                 (f"c in (-0.05, 1.1) ([{r.c.min():.4f}, {r.c.max():.4f}])",
                  r.c.min() > -0.05 and r.c.max() < 1.1)],
                [f"  {len(d)} load steps, total Newton "
                 f"{sum(r.newton_per_step)}, max damage {max(d):.4f}"])
    raise ValueError(name)


# Thermoforming at M = 48 walks a tail that residuals differing in their
# 12th digit change once alpha reaches its cap 2^14 at LVPP step 11
# (ROADMAP section C; 44 to over 100 LVPP steps on the card): the record
# runs its 10 LVPP steps before the cap, each Newton count held to the
# reference's; `--sizes models` runs thermoforming whole at M = 150
THERMOFORMING_HELD_STEPS = 10
# Fracture's record runs its first 9 of 29 load steps (their loads equal
# the record's bit for bit; 208 of its 908 Newton steps), so that the
# smoke run, with phase 11's 24^2 multiphase LU record of about 400 s of
# host SuperLU, stays well inside its time limit; `--sizes` runs all 29
FRACTURE_LOAD_STEPS = 9


def counts_agree(name: str, counts: dict) -> tuple:
    """(agree, what was compared) of a record run's counts and the pinned
    ones: equal, except thermoforming's, which runs its first
    THERMOFORMING_HELD_STEPS LVPP steps, and fracture's, its first
    FRACTURE_LOAD_STEPS load steps: their counts are compared over
    those."""
    ref = REFERENCE_COUNTS[name]
    if name == "thermoforming":
        k = THERMOFORMING_HELD_STEPS
        return (counts == {"lvpp": k, "newton": ref["newton"][:k]},
                f"the {k} LVPP steps' Newton counts")
    if name == "fracture":
        k = FRACTURE_LOAD_STEPS
        return ({key: v[:k] if isinstance(v, list) else v
                 for key, v in counts.items()}
                == {key: v[:k] if isinstance(v, list) else v
                    for key, v in ref.items()},
                f"the counts of the first {k} load steps")
    return counts == ref, "all counts"


def phase_model_cases(dev, cpu=None):
    """Phase 10 (i): each model at the smallest case of its parity test,
    the card against the CPU (counts and fields; nothing timed)."""
    print("== phase 10 (i): the LVPP example models, card against CPU",
          flush=True)
    card_vs_cpu(dev, "10", cpu)


def phase_model_records(dev, names=MODELS):
    """Phase 10 (ii): each model at its record size, timed."""
    print("== phase 10 (ii): the LVPP example models at their record sizes",
          flush=True)
    from proximalgalerkin_torch.core.logging import PhaseTimer
    for name in names:
        timer = PhaseTimer(dev)
        reset_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        counts, checks, lines = model_record(name, dev, timer)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        launches = read_counters()
        ref = REFERENCE_COUNTS[name]
        tot = timer.totals
        lu = tot.get("lu_factor", 0.0) + tot.get("lu_solve", 0.0)
        asm = tot.get("assembly", 0.0)
        res = tot.get("residual", 0.0) + tot.get("linesearch", 0.0)
        print(f"{name} (ii) record size: {secs:.2f} s, counts {counts}; "
              f"reference {ref}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"launches of the port's CUDA kernels {launches}", flush=True)
        for line in lines:
            print(line, flush=True)
        if tot:
            print(f"  shares of the run: SuperLU (lu_factor + lu_solve) "
                  f"{100 * lu / secs:.1f}%, element-matrix assembly "
                  f"{100 * asm / secs:.1f}%, residuals (Newton and line "
                  f"search) {100 * res / secs:.1f}%; PhaseTimer:\n    "
                  + timer.report().replace("\n", "\n    "), flush=True)
        for what, ok in checks:
            print(f"  check {what}: {'ok' if ok else 'FAILED'}", flush=True)
            check(ok, f"{name} (ii) {what}")
        agree, what = counts_agree(name, counts)
        print(f"  counts against the pinned ones ({what}): "
              f"{'equal' if agree else 'DIFFERENT'}", flush=True)
        check(all(v == 0 for v in launches.values()),
              f"{name} (ii) launches none of the port's CUDA kernels")
        check(agree, f"{name} (ii) {what} equal the pinned ones")


# Phase 11: the block-tridiagonal direct direction (la/blocktri.py,
# pc_type='btlu') and the multiphase model (models/multiphase.py).
BTLU = {"ksp_type": "preonly", "pc_type": "btlu"}
# The full-LVPP cases of tests/test_torch_blocktri.py; cyclic reduction
# refines to 1e-11 as the reference's test does
BTLU_CASES = {
    "thomas_f32": {"ksp_rtol": 1e-9},
    "cr": {"pc_factor_algo": "cr", "ksp_rtol": 1e-11},
    "streamed": {"pc_factor_streamed": True, "ksp_rtol": 1e-9},
    "lagged_f64_f32apply": {"pc_factor_lag": 1, "pc_factor_dtype": "f64",
                            "pc_factor_apply_dtype": "f32",
                            "ksp_rtol": 1e-9},
}
# The multiphase record's option set (tests/test_multiphase.py)
MULTIPHASE_FUSED = {"snes_fused": True, "ksp_type": "preonly",
                    "pc_type": "btlu", "ksp_rtol": 1e-9,
                    "pc_factor_dtype": "f64", "pc_factor_lag": 1}
MULTIPHASE_CASES = {"lu": None, "fused_btlu": MULTIPHASE_FUSED}
# The JAX package's CPU counts: multiphase at the RESULTS.md:164 record
# (24^2, dt 1e-4, 5 steps, tol 1e-5, default options; the record says
# Newton [74, 45, 46, 44, 44]) and the first 5 steps of the CLI's 50^2
# protocol (dt 1e-5, tol 1e-5, with the record's lagged nested-dissection
# LU, pc_factor_lag 1 and pc_factor_ordering nd: SuperLU's own ordering
# takes minutes a factor there; records/rec_multiphase_50.jsonl has the
# same counts)
REFERENCE_COUNTS["multiphase_24"] = {"newton": [75, 45, 46, 44, 44],
                                     "lvpp": [20, 20, 20, 20, 20]}
REFERENCE_COUNTS["multiphase_50"] = {"newton": [77, 45, 32, 34, 31],
                                     "lvpp": [20, 20, 14, 15, 14]}
def btlu_case(name: str, dev):
    """The gradient-constraint 12^2 P2 LVPP of tests/test_torch_blocktri.py
    with the btlu option set `name` (or "lu", the default direction) on
    dev: (counts, fields as host arrays)."""
    from proximalgalerkin_torch.models import gradient_constraint
    opts = None if name == "lu" else {**BTLU, **BTLU_CASES[name]}
    prob, r = gradient_constraint.solve_gradient_constraint(
        N=12, M=12, primal_degree=2, max_iterations=25, stopping_tol=1e-8,
        verbose=False, quadrature_degree=6, device=dev,
        solver_options=opts)
    return ({"lvpp": r.iterations, "newton": r.newton_steps,
             "converged": r.converged}, {"x": r.x.cpu().numpy()})


def multiphase_case(name: str, dev):
    """Multiphase at N = 10, two steps of dt 1e-4 (tests/test_torch_
    multiphase.py) on dev with MULTIPHASE_CASES[name]: (counts, fields)."""
    from proximalgalerkin_torch.models.multiphase import solve_multiphase
    r = solve_multiphase(N=10, M=10, tau0=1e-4, T=2e-4, stopping_tol=1e-5,
                         verbose=False, device=dev,
                         solver_options=MULTIPHASE_CASES[name])
    return ({"newton": r.newton_iterations.tolist(),
             "lvpp": r.lvpp_iterations.tolist()}, {"u": r.u})


def shares(timer, secs: float) -> str:
    tot = timer.totals
    parts = [f"{k} {100 * tot.get(k, 0.0) / secs:.1f}% "
             f"({tot.get(k, 0.0):.2f} s over {timer.counts.get(k, 0)})"
             for k in ("bt_factor", "bt_solve", "bt_assemble", "lu_factor",
                       "lu_solve", "assembly", "residual", "linesearch")
             if k in tot]
    return ", ".join(parts)


def timed_run(dev, run):
    """run(timer) on dev with the kernel counters at 0 and the device's
    peak memory reset: (its result, seconds, PhaseTimer, launches of the
    port's CUDA kernels, peak GiB)."""
    from proximalgalerkin_torch.core.logging import PhaseTimer
    timer = PhaseTimer(dev)
    reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = run(timer)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    return (out, secs, timer, read_counters(),
            torch.cuda.max_memory_allocated(dev) / 2**30)


def phase_btlu_cases(dev, cpu=None):
    """Phase 11 (i): the smallest case of each new parity test, the card
    against the CPU (counts and fields; nothing timed)."""
    print("== phase 11 (i): btlu and multiphase, card against CPU",
          flush=True)
    on_card = card_vs_cpu(dev, "11", cpu)
    # the LU direction on the card at the same size: every btlu option
    # set takes its counts (the CPU parity test holds btlu to the JAX
    # package's LU run)
    c_lu, _ = btlu_case("lu", dev)
    print(f"gradient 12^2 P2 LU on the card: counts {c_lu}", flush=True)
    check(all(on_card[BTLU_LABEL + name] == c_lu for name in BTLU_CASES),
          "gradient 12^2 P2: btlu counts equal LU's on the card")


def phase_btlu(dev, lvpp_a, multiphase_24=None):
    """Phase 11 (ii)-(v); lvpp_a: phase 9 (a)'s (result, seconds,
    PhaseTimer); multiphase_24: (iv)'s readings from its RecordProcess,
    or None to run (iv) here."""
    print("== phase 11 (ii)-(v): block-tridiagonal direct direction (btlu) "
          "and multiphase", flush=True)
    # (ii) phase 9's 160^2 obstacle with btlu, beside (a)'s LU run
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    res_a, secs_a, timer_a = lvpp_a
    n = LVPP_N
    mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    for fdt in ("f64", "f32"):
        opts = {**BTLU, "ksp_rtol": 1e-9, "pc_factor_dtype": fdt}

        def run(timer):
            prob = setup_obstacle_problem(
                mesh, polynomial_order=1, alpha_scheme="double_exponential",
                alpha_max=1e2, tol_exit=1e-6, verbose=False, device=dev,
                solver_options=opts)
            return prob, prob.solve()

        (prob, res), secs, _, launches, peak = timed_run(dev, run)
        timer = prob.solver.timer
        blk = prob.problem.line_blocking()
        print(f"{n}^2 (ii) btlu {fdt} factor (nb {blk.nb}, bs {blk.bs}): "
              f"{secs:.2f} s against (a)'s LU {secs_a:.2f} s, outer "
              f"{res.iterations} newton_steps {res.newton_steps} converged "
              f"{res.converged}; (a) {res_a.iterations} / "
              f"{res_a.newton_steps}; peak device memory {peak:.2f} GiB; "
              f"launches of the port's CUDA kernels {launches}", flush=True)
        print(f"  shares: {shares(timer, secs)}; (a): "
              f"{shares(timer_a, secs_a)}", flush=True)
        print("  PhaseTimer:\n    " + timer.report().replace("\n", "\n    "),
              flush=True)
        check_launches(launches, f"(ii) {fdt}", uses=("bt_apply",))
        # the JAX package's CPU runs break down here (f64 at outer step
        # 7, f32 one step earlier): its equilibration scales latent rows
        # by diagonals near underflow (la/blocktri._equilibrate); the
        # port's btlu takes (a)'s LU outcome, which
        # tests/test_torch_blocktri.py holds at 40^2 against the JAX
        # package's f64 btlu run
        got = {"lvpp": res.iterations, "newton_steps": res.newton_steps,
               "converged": res.converged}
        want = {"lvpp": res_a.iterations, "newton_steps": res_a.newton_steps,
                "converged": True}
        check(got == want, f"(ii) {fdt} outcome {got} equals (a)'s {want}")

    # (iii) the two P2/P3 records of phase 10 with btlu
    from proximalgalerkin_torch.models import (eigenvalue_constraints,
                                               gradient_constraint)
    records = (
        ("gradient_constraint", lambda tm: gradient_constraint.
         solve_gradient_constraint(
             N=48, M=48, primal_degree=2, alpha_scheme="doubling",
             stopping_tol=1e-8, verbose=False, device=dev, timer=tm,
             solver_options={**BTLU, "ksp_rtol": 1e-9})[1],
         lambda r: ({"lvpp": r.iterations, "newton": r.newton_steps},
                    r.converged)),
        ("eigenvalue", lambda tm: eigenvalue_constraints.
         solve_eigenvalue_constraints(
             N=20, degree=3, tol=1e-10, verbose=False, device=dev,
             timer=tm, solver_options={**BTLU, "ksp_rtol": 1e-9}),
         lambda r: ({"lvpp": r.lvpp.iterations,
                     "newton": r.lvpp.newton_steps}, r.lvpp.converged)),
    )
    for name, run, counts_of in records:
        r, secs, timer, launches, peak = timed_run(dev, run)
        counts, converged = counts_of(r)
        print(f"{name} (iii) record size with btlu f32: {secs:.2f} s, "
              f"counts {counts}; pinned LU {REFERENCE_COUNTS[name]}; peak "
              f"device memory {peak:.2f} GiB; launches {launches}",
              flush=True)
        print(f"  shares: {shares(timer, secs)}; PhaseTimer:\n    "
              + timer.report().replace("\n", "\n    "), flush=True)
        check(converged, f"{name} (iii) converged")
        check(counts == REFERENCE_COUNTS[name], f"{name} (iii) counts")
        check_launches(launches, f"{name} (iii)", uses=("bt_apply",))

    # (iv) multiphase at the 24^2 record (LU); (v) the CLI's 50^2 width
    # (fused lagged btlu)
    report_multiphase(multiphase_24 or multiphase_record("multiphase_24",
                                                         dev))
    report_multiphase(multiphase_record("multiphase_50", dev))
    bt_timings(dev)


def bt_timings(dev):
    """Time of one block-Thomas factor (bt_factor) and one apply
    (bt_apply) on the card at the block shapes of (ii) and (v), on random
    quasi-definite blocks made from SEED (the apply in (v)'s dtype: the
    f64 factor cast to f32), per call between CUDA events."""
    from proximalgalerkin_torch.la import blocktri as bt
    rng = np.random.default_rng(SEED)
    for label, nb, bs, fdt, adt in (
            ("(ii) 160^2 f64", 161, 322, torch.float64, torch.float64),
            ("(ii) 160^2 f32", 161, 322, torch.float32, torch.float32),
            ("(v) 50^2 f64 factor, f32 apply", 51, 1212, torch.float64,
             torch.float32)):
        def blocks(n):
            return torch.as_tensor(rng.standard_normal((n, bs, bs))
                                   * (0.3 / np.sqrt(bs)), dtype=fdt,
                                   device=dev)
        sgn = torch.as_tensor(np.where(rng.random((nb, bs)) > 0.5, 4.0,
                                       -4.0), dtype=fdt, device=dev)
        D = blocks(nb) + torch.diag_embed(sgn)
        L, U = blocks(nb - 1), blocks(nb - 1)
        b = torch.as_tensor(rng.standard_normal((nb, bs)), dtype=adt,
                            device=dev)
        Minv, T = bt.bt_factor(D, L, U)
        ms_factor = per_call_ms(lambda: bt.bt_factor(D, L, U), calls=3)
        Minv, T, La = Minv.to(adt), T.to(adt), L.to(adt)
        ms_apply = per_call_ms(lambda: bt.bt_apply(Minv, T, La, b),
                               calls=20)
        print(f"btlu {label} (nb {nb}, bs {bs}): {ms_factor:.2f} ms a "
              f"factor, {ms_apply:.3f} ms an apply", flush=True)
        del D, L, U, Minv, T, La


# (title, size, options, the REFERENCE_COUNTS key its counts are a prefix
# of). The smoke run's (iv) runs the first of the 24^2 record's 5 steps
# (75 of its 254 host SuperLU factors), a depth cut that keeps the whole
# run inside its time limit; `--sizes` runs all 5
MULTIPHASE_RECORDS = {
    "multiphase_24": ("(iv) 24^2 dt 1e-4, the first of the record's 5 "
                      "steps, default LU",
                      dict(N=24, M=24, tau0=1e-4, T=1e-4), None,
                      "multiphase_24"),
    "multiphase_24_full": ("24^2 dt 1e-4, the record's 5 steps, default LU",
                           dict(N=24, M=24, tau0=1e-4, T=5e-4), None,
                           "multiphase_24"),
    "multiphase_50": ("(v) 50^2 dt 1e-5, first 5 steps, fused lagged btlu "
                      "(f64 factor, f32 apply, lag 1, snes_fused_chunk 3)",
                      dict(N=50, M=50, tau0=1e-5, T=5e-5),
                      {**MULTIPHASE_FUSED, "pc_factor_apply_dtype": "f32",
                       "snes_fused_chunk": 3}, "multiphase_50"),
}


def multiphase_record(key: str, dev) -> dict:
    """One run of MULTIPHASE_RECORDS[key] on dev, as a JSON-able dict of
    its readings."""
    from proximalgalerkin_torch.models.multiphase import solve_multiphase
    title, size, opts, pinned = MULTIPHASE_RECORDS[key]
    r, secs, timer, launches, peak = timed_run(
        dev, lambda tm: solve_multiphase(
            stopping_tol=1e-5, verbose=False, device=dev, timer=tm,
            solver_options=opts, **size))
    return {"key": key, "title": title, "secs": secs, "pinned": pinned,
            "counts": {"newton": r.newton_iterations.tolist(),
                       "lvpp": r.lvpp_iterations.tolist()},
            "refactors": r.refactors_per_step.tolist(),
            "dmass": max(abs(float(m[0]) - 1.0) for m in r.mass_history),
            "rows": float(np.abs(r.u.reshape(-1, 4).sum(axis=1)
                                 - 1.0).max()),
            "peak_gib": peak, "launches": launches,
            "shares": shares(timer, secs), "timer": timer.report()}


def report_multiphase(rec: dict):
    """Print a multiphase_record's readings and check its counts (against
    as many steps of the pinned ones), mass, simplex rows and launches."""
    key = rec["key"]
    steps = len(rec["counts"]["newton"])
    pinned = {k: v[:steps] for k, v in
              REFERENCE_COUNTS[rec["pinned"]].items()}
    print(f"{key} {rec['title']}: {rec['secs']:.2f} s "
          f"({rec['secs'] / steps:.2f} s a step), counts {rec['counts']}; "
          f"pinned {pinned}; refactors per step "
          f"{rec['refactors']}; max |mass - 1| {rec['dmass']:.2e} (bound "
          f"1e-10); max |row sum - 1| {rec['rows']:.2e} (bound 1e-6); peak "
          f"device memory {rec['peak_gib']:.2f} GiB; launches "
          f"{rec['launches']}", flush=True)
    print(f"  shares: {rec['shares']}; PhaseTimer:\n    "
          + rec["timer"].replace("\n", "\n    "), flush=True)
    check(steps > 0 and rec["counts"] == pinned, f"{key} counts")
    check(rec["dmass"] <= 1e-10, f"{key} mass conserved")
    check(rec["rows"] <= 1e-6, f"{key} simplex row sums")
    # the fused lagged btlu applies its dense factor with the kernel
    check_launches(rec["launches"], key, uses=(
        ("bt_apply",) if MULTIPHASE_RECORDS[key][2] else ()))


# Phase 12: the block-Schur preconditioners (la/schur.py, la/gmg.py,
# pc_type='schur'/'schur_mg', mixed precision under them) with the eikonal
# and Monge–Ampère models (models/eikonal.py, models/monge_ampere.py).
SCHUR_MINRES = {"ksp_type": "minres", "ksp_rtol": 1e-10, "ksp_atol": 1e-12,
                "ksp_max_it": 3000}
# The gradient constraint's lattice-multigrid Schur option set
GRADIENT_SCHUR_MG = {"ksp_type": "minres", "pc_type": "schur_mg",
                     "ksp_precision": "mixed", "pc_schur_field0": "psi"}
FUSED_SCHUR = {"snes_fused": True, "ksp_type": "minres",
               "pc_schur_field0": "psi", "ksp_rtol": 1e-10,
               "ksp_max_it": 4000}
# (i): the smallest case of each new CPU parity test, with the bound on
# max |card - cpu| / max |cpu| of its fields: 1e-10, the MINRES
# directions at ksp_rtol 1e-10 1e-8
SCHUR_CASES = {"gmg_v_cycle_var": 1e-12, "eikonal_lu": 1e-10,
               "eikonal_schur": 1e-8, "star_lu": 1e-10,
               "gradient_fused_schur": 1e-8,
               "gradient_first_step_schur_mg": 1e-8,
               "gradient_first_step_schur_mg_mixed": 1e-8,
               "monge_ampere": 1e-10}
# The JAX package's CPU counts at the records (RESULTS.md:172-175): the
# Möbius strip 48x6 (LU; its Schur-MINRES default takes the same counts;
# RESULTS.md says 39 Newton, today 38), the star at res 0.08, the ball at
# res 0.3 (at the CLI's res 0.15, 63,315 dofs, the JAX package's CPU run
# did not end within 50 minutes), and the Monge–Ampère p-sweep k = 3..8
# (RESULTS.md says Newton 6 -> 2; today 5 -> 2) with its L2 errors
REFERENCE_COUNTS["eikonal_mobius"] = {
    "lvpp": 21, "newton": [2, 2, 2, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                           1, 1, 1, 1, 1]}
REFERENCE_COUNTS["eikonal_star"] = {
    "lvpp": 19, "newton": [2, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1,
                           1, 1, 1]}
REFERENCE_COUNTS["eikonal_ball_0.3"] = {
    "lvpp": 20, "newton": [3, 3, 4, 4, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                           1, 1, 1, 1]}
REFERENCE_COUNTS["monge_ampere"] = {"newton": [5, 4, 3, 3, 2, 2]}
MONGE_AMPERE_ERRORS = [0.01065379383420068, 0.001277181849429722,
                       0.00019087560160978425, 2.297435525951814e-05,
                       3.1095484788476377e-06, 3.544922601673521e-07]
# Phase 12 (iv): the gradient constraint at its CLI width, 200^2 P2
# (241,603 dofs), with GRADIENT_SCHUR_MG, through its entry point
# (solve_gradient_constraint) cut to the first Newton step of its LVPP
# (alpha = 1, from x0 = 0; snes_max_it 1, so the Newton solve stops with
# DIVERGED_MAX_IT and the LVPP loop with no step taken). The f32 MINRES
# inside the f64 refinement takes thousands of iterations a Newton step
# at every size: on an H100 the first LVPP step (5 Newton steps) took
# 595.6 s; and from 48^2 on the LVPP does not converge in the JAX
# package, with an outcome that changes from run to run (ROADMAP section
# C). `--sizes` runs the first LVPP step. The refinement stops once a
# pass gains less than 10%, and the relative residual of the refined
# direction grows with the mesh in both packages: the JAX package's CPU
# runs (scripts/jax_reference_records.py dir_N) read 5.9e-12, 5.6e-11,
# 7.8e-10, 3.1e-9, 4.8e-8, 9.7e-8 and 8.5e-7 at N = 16, 32, 48, 64, 96,
# 128 and 200, and the f32 solve alone (ksp_refine_max 0, dir0_N) 3.8e-4,
# 1.2e-3 and 1.2e-2 at 64, 96 and 200; the port on an H100 (`--sizes
# first_steps`) 3.3e-9, 4.9e-8, 1.1e-7 and 8.8e-7 at 64, 96, 128 and
# 200, without refinement 3.8e-4, 1.2e-3, 2.9e-3 and 1.2e-2, and on the
# CPU as the JAX package at 64 (tests/test_torch_schur.py).
# GRADIENT_200_RESIDUAL lies between the two at 200^2; the reference
# test's 1e-8 is set at 16^2.
GRADIENT_200_RESIDUAL = 1e-5
GRADIENT_200 = dict(N=200, M=200, primal_degree=2, alpha_scheme="doubling",
                    stopping_tol=1e-8)
# the one-step cap's pinned outcome: no LVPP step, one Newton step
GRADIENT_FIRST_STEP = {"lvpp": 0, "newton": [1], "reason": "DIVERGED_MAX_IT"}


class NewtonTap:
    """While open, records each NewtonSolver.solve's result and each
    Newton direction (x, F, dx) that NewtonSolver._solve_linear returns:
    the entry points' own solver, read from outside."""

    def __enter__(self):
        from proximalgalerkin_torch.solve.newton import NewtonSolver
        self.solves, self.directions = [], []
        self._real = (NewtonSolver.solve, NewtonSolver._solve_linear)
        real_solve, real_linear = self._real
        tap = self

        def solve(solver, x0):
            res = real_solve(solver, x0)
            tap.solves.append(res)
            return res

        def solve_linear(solver, x, F):
            dx = real_linear(solver, x, F)
            tap.directions.append((solver.problem, x, F, dx))
            return dx

        NewtonSolver.solve, NewtonSolver._solve_linear = solve, solve_linear
        return self

    def __exit__(self, *exc):
        from proximalgalerkin_torch.solve.newton import NewtonSolver
        NewtonSolver.solve, NewtonSolver._solve_linear = self._real


def gradient_first_step(dev, timer, N: int = 200, precision: str = "mixed",
                        refine_max=None) -> dict:
    """The N^2 P2 gradient constraint (GRADIENT_200's options) through
    solve_gradient_constraint with the schur_mg direction in `precision`
    (ksp_refine_max `refine_max`, None: the default 30), capped at one
    Newton step: its LVPP and Newton counts and reason, the step's x and
    dx on the host, |F(x1)| / |F(x0)|, and (x, F, dx) on dev for
    direction_residual."""
    from proximalgalerkin_torch.models import gradient_constraint
    opts = {**GRADIENT_SCHUR_MG, "ksp_precision": precision,
            "snes_max_it": 1}
    if refine_max is not None:
        opts["ksp_refine_max"] = refine_max
    with NewtonTap() as tap:
        prob, r = gradient_constraint.solve_gradient_constraint(
            max_iterations=1, verbose=False, device=dev, timer=timer,
            solver_options=opts, **{**GRADIENT_200, "N": N, "M": N})
    (res,), (step,) = tap.solves, tap.directions
    dx = step[3]
    return {"lvpp": r.iterations, "newton": [res.iterations],
            "reason": res.reason.name, "dofs": prob.space.num_dofs,
            "fratio": res.fnorm_history[-1] / res.fnorm_history[0],
            "x": res.x.cpu().numpy(), "dx": dx.cpu().numpy(),
            "finite": bool(torch.isfinite(dx).all()), "step": step}


def direction_residual(r: dict) -> float:
    """|J dx + F| / |F| of gradient_first_step's direction, J the f64 ELL
    Jacobian at its x."""
    p, x, F, dx = r["step"]
    return float(torch.linalg.norm(p.ell_matrix.spmv(p.ell_data(x), dx) + F)
                 / torch.linalg.norm(F))


def schur_case(name: str, dev):
    """The smallest case of each new parity test (tests/test_torch_gmg.py,
    _schur.py, _eikonal.py, _monge_ampere.py) on dev: (counts, fields as
    host arrays)."""
    from proximalgalerkin_torch.models import gradient_constraint
    from proximalgalerkin_torch.models.eikonal import solve_eikonal
    if name == "gmg_v_cycle_var":
        from proximalgalerkin_torch.la import gmg
        rng = np.random.default_rng(SEED)
        m = 65
        free = np.zeros((m, m), bool)
        free[1:-1, 1:-1] = True

        def t(a):
            return torch.as_tensor(a, device=dev)

        h = gmg.build_hierarchy_var(
            t(rng.uniform(0.5, 2.0, (m, m))),
            t(np.where(free, rng.uniform(0.0, 0.1, (m, m)), 0.0)), t(free),
            gmg.mg_levels_for(m))
        z = gmg.v_cycle_var(t(np.where(free, rng.normal(size=(m, m)), 0.0)),
                            h)
        return {"levels": len(h)}, {"z": z.cpu().numpy()}
    if name in ("eikonal_lu", "eikonal_schur", "star_lu"):
        mesh = None
        if name == "star_lu":
            from proximalgalerkin_torch.mesh.unstructured import \
                create_star_mesh
            mesh = create_star_mesh(0.12)
        r = solve_eikonal(mesh=mesh, ns=12, nt=3, verbose=False, device=dev,
                          solver_options=(SCHUR_MINRES if name ==
                                          "eikonal_schur" else None))
        return ({"lvpp": r.lvpp_iterations, "newton": r.newton_iterations,
                 "converged": r.converged}, {"u": r.u})
    if name == "gradient_fused_schur":
        prob, r = gradient_constraint.solve_gradient_constraint(
            N=8, M=8, primal_degree=2, max_iterations=1, stopping_tol=1e-6,
            verbose=False, quadrature_degree=4, device=dev,
            solver_options={**FUSED_SCHUR, "pc_type": "schur"})
        return ({"lvpp": r.iterations, "newton": r.newton_steps},
                {"x": r.x.cpu().numpy()})
    if name.startswith("gradient_first_step_"):
        r = gradient_first_step(dev, None, N=8, precision=(
            "mixed" if name.endswith("_mixed") else "double"))
        return ({k: r[k] for k in ("lvpp", "newton", "reason", "dofs")},
                {"x": r["x"], "dx": r["dx"]})
    if name == "monge_ampere":
        from proximalgalerkin_torch.models.monge_ampere import \
            p_refinement_sweep
        s = p_refinement_sweep(3, 4, verbose=False, device=dev)
        return {"newton": s.newton_its}, {"errors": np.array(s.errors)}
    raise ValueError(name)


def phase_schur_cases(dev, cpu=None):
    """Phase 12 (i): the smallest case of each new parity test, the card
    against the CPU (counts and fields; nothing timed)."""
    print("== phase 12 (i): block-Schur, eikonal and Monge–Ampère, card "
          "against CPU", flush=True)
    card_vs_cpu(dev, "12", cpu)


class SchurTally(MinresTally):
    """MinresTally, and the time of the element matrices and their ELL
    assembly (VolumeForm._element_matrices_core, EllMatrix.assemble) and
    of the block-Schur preconditioner builds (la/schur.py make_schur_pc,
    make_schur_mg_pc), each synchronised before and after."""

    def __enter__(self):
        from proximalgalerkin_torch.assembly.assemble import VolumeForm
        from proximalgalerkin_torch.la import schur
        from proximalgalerkin_torch.la.ell import EllMatrix
        super().__enter__()
        self.asm_ms = self.pc_ms = 0.0
        self._patches = []
        for owner, name, field in (
                (VolumeForm, "_element_matrices_core", "asm_ms"),
                (EllMatrix, "assemble", "asm_ms"),
                (schur, "make_schur_pc", "pc_ms"),
                (schur, "make_schur_mg_pc", "pc_ms")):
            real = getattr(owner, name)

            def shim(*a, _real=real, _field=field, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*a, **kw)
                torch.cuda.synchronize()
                setattr(self, _field, getattr(self, _field)
                        + (time.perf_counter() - t0) * 1e3)
                return out

            setattr(owner, name, shim)
            self._patches.append((owner, name, real))
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._patches):
            setattr(owner, name, real)
        super().__exit__(*exc)


def schur_record(dev, title: str, run, counts_of, pinned, checks_of):
    """One record of phase 12 (ii)-(iv): run(timer) on dev under a
    SchurTally, its counts held to `pinned` and its checks, with its
    seconds, MINRES iterations a Newton step, ms a MINRES iteration, the
    shares of element matrices + assembly, preconditioner builds and
    MINRES, the PhaseTimer report, peak device memory and launches
    (pinned None: the counts are only printed)."""
    with SchurTally() as tally:
        r, secs, timer, launches, peak = timed_run(dev, run)
    counts = counts_of(r)
    newton = counts["newton"]
    n_newton = sum(newton) if isinstance(newton, list) else newton
    print(f"{title}: {secs:.2f} s, counts {counts}; pinned {pinned}; "
          f"MINRES {tally.its} iterations in {tally.calls} solves, "
          f"{tally.its / max(n_newton, 1):.1f} a Newton step, "
          f"{tally.ms / max(tally.its, 1):.3f} ms an iteration; peak device "
          f"memory {peak:.2f} GiB; launches of the port's CUDA kernels "
          f"{launches}", flush=True)
    print(f"  shares: element matrices + assembly "
          f"{100 * tally.asm_ms / 1e3 / secs:.1f}%, preconditioner builds "
          f"{100 * tally.pc_ms / 1e3 / secs:.1f}%, MINRES (with its "
          f"preconditioner applies) {100 * tally.ms / 1e3 / secs:.1f}%; "
          f"{shares(timer, secs)}; PhaseTimer:\n    "
          + timer.report().replace("\n", "\n    "), flush=True)
    for what, ok in checks_of(r):
        print(f"  check {what}: {'ok' if ok else 'FAILED'}", flush=True)
        check(ok, f"{title}: {what}")
    if pinned is not None:
        check(counts == pinned, f"{title}: counts equal the pinned ones")
    check(all(v == 0 for v in launches.values()),
          f"{title}: launches none of the port's kernels")
    return r


def eikonal_checks(kind: str):
    """The reference tests' checks of an eikonal solution
    (tests/test_eikonal.py)."""
    def checks(r):
        u = r.u
        out = [("converged", r.converged)]
        if kind == "mobius":
            out += [(f"|max u - 0.2| < 0.02 ({u.max():.4f})",
                     abs(u.max() - 0.2) < 0.02),
                    (f"min u > -1e-3 ({u.min():.3e})", u.min() > -1e-3)]
        elif kind == "star":
            a = np.array([0.0, 1.0])
            b = 0.45 * np.array([np.cos(np.pi / 2 + np.pi / 5),
                                 np.sin(np.pi / 2 + np.pi / 5)])
            t = -np.dot(a, b - a) / np.dot(b - a, b - a)
            d = float(np.linalg.norm(a + t * (b - a)))
            out += [(f"min u > -0.02 ({u.min():.3e})", u.min() > -0.02),
                    (f"|max u - {d:.4f}| < 0.1 * {d:.4f} ({u.max():.4f})",
                     abs(u.max() - d) < 0.1 * d)]
        else:
            out += [(f"min u > -0.05 ({u.min():.3e})", u.min() > -0.05),
                    (f"0.5 < max u <= 1.05 ({u.max():.4f})",
                     0.5 < u.max() <= 1.05)]
        return out + [(f"LVPP {r.lvpp_iterations} < 60", r.lvpp_iterations
                       < 60)]
    return checks


def ball_record(dev):
    """Phase 12 (ii)'s eikonal ball at res 0.3 with LU."""
    from proximalgalerkin_torch.mesh.parametric import create_ball_mesh
    eikonal_record(dev, "eikonal (ii) ball res 0.3, LU", "eikonal_ball_0.3",
                   {"mesh": create_ball_mesh(res=0.3)})


def phase_schur(dev, ball=None):
    """Phase 12 (ii)-(iv), timed. ball: the readings of ball_record's
    child (RecordProcess("eikonal_ball"), its checks passed there), else
    the ball runs in line."""
    print("== phase 12 (ii)-(iv): eikonal, Monge–Ampère and the lattice "
          "block-Schur direction", flush=True)
    from proximalgalerkin_torch.mesh.unstructured import create_star_mesh
    from proximalgalerkin_torch.models.monge_ampere import p_refinement_sweep

    # (ii) the eikonal records
    for title, key, kw in (
            ("eikonal (ii) Möbius 48x6, LU", "eikonal_mobius", {}),
            ("eikonal (ii) Möbius 48x6, Schur-MINRES", "eikonal_mobius",
             {"solver_options": SCHUR_MINRES}),
            ("eikonal (ii) star res 0.08, LU", "eikonal_star",
             {"mesh": create_star_mesh(0.08)})):
        eikonal_record(dev, title, key, kw)
    if ball is None:
        ball_record(dev)
    else:
        print(ball["out"], flush=True)

    # (iii) the Monge–Ampère p-sweep
    def ma_checks(s):
        rel = max(abs(e - r) / r for e, r in zip(s.errors,
                                                  MONGE_AMPERE_ERRORS))
        return [(f"L2 errors {[float(f'{e:.4g}') for e in s.errors]} within "
                 f"1e-6 relative of the JAX package's ({rel:.2e})",
                 rel <= 1e-6)]

    schur_record(dev, "monge-ampere (iii) p-sweep k = 3..8, LU",
                 lambda tm: p_refinement_sweep(3, 8, verbose=False,
                                               device=dev, timer=tm),
                 lambda s: {"newton": s.newton_its},
                 REFERENCE_COUNTS["monge_ampere"], ma_checks)

    # (iv) the 200^2 gradient constraint's first Newton step
    first_step_record(dev, 200)


def eikonal_record(dev, title: str, key: str, kw: dict):
    """One eikonal record (Möbius 48x6 unless kw has a mesh) under
    schur_record, its counts held to REFERENCE_COUNTS[key] and the
    reference tests' checks."""
    from proximalgalerkin_torch.models.eikonal import solve_eikonal
    schur_record(dev, title, lambda tm: solve_eikonal(
        ns=48, nt=6, verbose=False, device=dev, timer=tm, **kw),
        lambda r: {"lvpp": r.lvpp_iterations, "newton": r.newton_iterations},
        REFERENCE_COUNTS[key], eikonal_checks(key.split("_")[1]))


def first_step_record(dev, N: int, refine_max=None):
    """Phase 12 (iv) at N^2: gradient_first_step under schur_record, its
    counts held to GRADIENT_FIRST_STEP; the direction finite, the step
    lowering |F|, and the direction's relative residual under
    GRADIENT_200_RESIDUAL, or, with refine_max 0 (the f32 solve alone,
    the control), over it."""
    control = refine_max == 0

    def checks(r):
        rel = direction_residual(r)
        side = ">=" if control else "<"
        return [("dx finite", r["finite"]),
                (f"|F(x1)| / |F(x0)| {r['fratio']:.3e} < 1",
                 r["fratio"] < 1),
                (f"|J dx + F| / |F| {rel:.3e} {side} "
                 f"{GRADIENT_200_RESIDUAL:.0e} ({r['dofs']} dofs)",
                 (rel >= GRADIENT_200_RESIDUAL) if control
                 else (rel < GRADIENT_200_RESIDUAL))]

    what = "no refinement (control)" if control else "refined"
    return schur_record(
        dev, f"gradient (iv) {N}^2 P2, schur_mg mixed, {what}, first Newton "
        "step", lambda tm: gradient_first_step(dev, tm, N,
                                               refine_max=refine_max),
        lambda r: {k: r[k] for k in GRADIENT_FIRST_STEP},
        GRADIENT_FIRST_STEP, checks)


# Phase 13: Signorini contact (spaces/trace.py, assembly/facets.py,
# solve/composite.py, models/signorini.py), the bound-constrained
# baselines (solve/optimization.py, solve/vi.py, models/obstacle_qp.py),
# utils/profiling.py and bench --mode fd|stream.
# (i): the smallest case of each new CPU parity test
CONTACT_CASES = ("signorini_2d", "signorini_3d", "compare_all")
# The JAX package's CPU counts at the records (RESULTS.md:160-162), from
# scripts/jax_reference_records.py sig2d_0.10, sig2d_0.15, sig2d_0.20,
# sig3d and compare_all: the half-disk at res 0.04 pressed by 0.10, 0.15
# and 0.20, the half-sphere at res 0.12, the five solvers on the disk at
# res 0.1 (tol 1e-4)
REFERENCE_COUNTS["signorini_2d_0.10"] = {"lvpp": 6,
                                         "newton": [7, 3, 1, 1, 1, 1]}
REFERENCE_COUNTS["signorini_2d_0.15"] = {"lvpp": 7,
                                         "newton": [11, 3, 1, 1, 1, 1, 1]}
REFERENCE_COUNTS["signorini_2d_0.20"] = {
    "lvpp": 9, "newton": [7, 2, 1, 1, 1, 1, 1, 1, 1]}
REFERENCE_COUNTS["signorini_3d_0.12"] = {
    "lvpp": 10, "newton": [6, 3, 2, 1, 1, 1, 1, 1, 1, 1]}
REFERENCE_COUNTS["compare_all"] = {
    "Galahad (TRB)": 6, "LVPP (P1)": 21, "LVPP (P2)": 27,
    "IPOPT (w. Hessian)": 140, "IPOPT (no Hessian)": 140, "SNES-VI": 5}
# (iii) the width reading: the half-sphere at res 0.06 (13,883 cells,
# 8,317 dofs) cut to its first SIGNORINI_WIDTH_STEPS LVPP steps; the JAX
# package's CPU run (sig3d_006) took 27.8 s for them, and its whole
# trajectory did not end within 300 s. `--sizes signorini_width` runs the
# whole trajectory.
SIGNORINI_WIDTH_STEPS = 5
REFERENCE_COUNTS["signorini_3d_0.06"] = {"lvpp": 5,
                                         "newton": [5, 3, 2, 1, 1]}
# (iv) bench --mode fd -n 1024 is phase 8's solve: its counts
FD_1025_COUNTS = {"outer": 14, "newton": 23}


def contact_case(name: str, dev):
    """The smallest case of each new parity test
    (tests/test_torch_signorini.py, _compare_solvers.py) on dev: (counts,
    fields as host arrays). compare_all's fields leave out the interior
    point without the Hessian, which stops at its cap of 20 steps a
    barrier level mid-descent, where the last bits of the QP operators
    move its iterate (tests/test_torch_compare_solvers.py)."""
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.mesh.parametric import create_half_sphere
    from proximalgalerkin_torch.models.obstacle_qp import compare_all
    from proximalgalerkin_torch.models.signorini import solve_signorini
    if name.startswith("signorini"):
        kw = (dict(res=0.06) if name == "signorini_2d"
              else dict(tagged=create_half_sphere(res=0.16)))
        r = solve_signorini(disp=-0.10, verbose=False, max_iterations=20,
                            device=dev, **kw)
        return ({"lvpp": r.lvpp_iterations, "newton": r.newton_iterations,
                 "converged": r.converged},
                {"u": r.u, "psi": r.psi,
                 "penetrations": np.array(r.penetrations),
                 "von_mises": r.von_mises})
    if name == "compare_all":
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r = compare_all(rectangle_mesh(12, 12, p0=(-1.0, -1.0),
                                           p1=(1.0, 1.0)),
                            verbose=False, max_iter=500, tol=1e-4, device=dev)
        return (dict(r.iterations),
                {k: v for k, v in r.solutions.items()
                 if k != "IPOPT (no Hessian)"})
    raise ValueError(name)


def phase_contact_cases(dev, cpu=None):
    """Phase 13 (i): the card against the CPU (counts and fields; nothing
    timed)."""
    print("== phase 13 (i): Signorini and the five solvers, card against "
          "CPU", flush=True)
    card_vs_cpu(dev, "13", cpu)


def contact_record(dev, title: str, run, counts_of, pinned, checks_of):
    """One record of phase 13 (ii)-(iii): run(timer) on dev, its counts
    held to `pinned` and its checks, with its seconds, the shares of its
    PhaseTimer phases, peak device memory and launches of the port's
    kernels (none)."""
    r, secs, timer, launches, peak = timed_run(dev, run)
    counts = counts_of(r)
    print(f"{title}: {secs:.2f} s, counts {counts}; pinned {pinned}; peak "
          f"device memory {peak:.3f} GiB; launches of the port's CUDA "
          f"kernels {launches}", flush=True)
    print("  shares: " + ", ".join(
        f"{k} {100 * v / secs:.1f}%" for k, v in timer.totals.items())
        + "; PhaseTimer:\n    " + timer.report().replace("\n", "\n    "),
        flush=True)
    for what, ok in checks_of(r):
        print(f"  check {what}: {'ok' if ok else 'FAILED'}", flush=True)
        check(ok, f"{title}: {what}")
    check(counts == pinned, f"{title}: counts equal the pinned ones")
    check(all(v == 0 for v in launches.values()),
          f"{title}: launches none of the port's kernels")
    return r


def signorini_checks(disp: float, pen_bound: float, axis: int):
    """The reference tests' checks of a Signorini solution
    (tests/test_signorini.py)."""
    def checks(r):
        return [("converged", r.converged),
                (f"final penetration {r.penetrations[-1]:.3e} < "
                 f"{pen_bound:.0e}", r.penetrations[-1] < pen_bound),
                (f"Dirichlet value reached: min u_{axis} "
                 f"{float(r.u[:, axis].min())!r} == {disp}",
                 bool(np.isclose(r.u[:, axis].min(), disp))),
                (f"psi finite, min psi {r.psi.min():.4g} < -1",
                 bool(np.isfinite(r.psi).all()) and r.psi.min() < -1.0)]
    return checks


def compare_checks(mesh):
    """compare_all's solutions against SNES-VI's within 5e-2 (the
    reference test's bound; LVPP (P2) at the P1 dofs' points), the
    interior point without the Hessian only printed: it stops at its cap
    mid-descent in both packages (0.68 from SNES-VI on this disk)."""
    from proximalgalerkin_torch.spaces import FunctionSpace

    def checks(r):
        p1 = FunctionSpace.create(mesh, 1).dof_points
        p2 = FunctionSpace.create(mesh, 2).dof_points
        pos = {tuple(np.round(p, 12)): i for i, p in enumerate(p2)}
        at_p1 = np.array([pos[tuple(np.round(p, 12))] for p in p1])
        ref = r.solutions["SNES-VI"]
        out = []
        for name in ("Galahad (TRB)", "LVPP (P1)", "LVPP (P2)",
                     "IPOPT (w. Hessian)", "IPOPT (no Hessian)"):
            s = r.solutions[name]
            d = float(np.abs((s[at_p1] if s.shape != ref.shape else s)
                             - ref).max())
            if name == "IPOPT (no Hessian)":
                print(f"  {name}: max |x - x_VI| {d:.3e} (not held)",
                      flush=True)
                continue
            out.append((f"{name}: max |x - x_VI| {d:.3e} < 5e-2", d < 5e-2))
        return out
    return checks


def phase_contact(dev, fd_res=None):
    """Phase 13 (ii)-(iv), timed. fd_res: phase 8's result, whose counts
    bench --mode fd must take (FD_1025_COUNTS without it)."""
    import warnings
    print("== phase 13 (ii)-(iv): Signorini, the five solvers, profiling "
          "and bench --mode fd|stream", flush=True)
    from proximalgalerkin_torch.mesh.parametric import create_half_sphere
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_torch.models.obstacle_qp import compare_all
    from proximalgalerkin_torch.models.signorini import solve_signorini

    def sig_counts(r):
        return {"lvpp": r.lvpp_iterations, "newton": r.newton_iterations}

    # (ii) the records
    for d in (0.10, 0.15, 0.20):
        contact_record(
            dev, f"signorini (ii) half-disk res 0.04, disp -{d:.2f}, LU",
            lambda tm, d=d: solve_signorini(res=0.04, disp=-d, verbose=False,
                                            device=dev, timer=tm),
            sig_counts, REFERENCE_COUNTS[f"signorini_2d_{d:.2f}"],
            signorini_checks(-d, 1e-3, 1))
    sphere = create_half_sphere(res=0.12)
    contact_record(
        dev, "signorini (ii) half-sphere res 0.12, LU",
        lambda tm: solve_signorini(tagged=sphere, verbose=False, device=dev,
                                   timer=tm),
        sig_counts, REFERENCE_COUNTS["signorini_3d_0.12"],
        signorini_checks(-0.10, 5e-3, 2))
    disk = create_disk_mesh(0.1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        contact_record(
            dev, "compare-all (ii) disk res 0.1, tol 1e-4",
            lambda tm: compare_all(disk, max_iter=500, tol=1e-4,
                                   verbose=False, device=dev, timer=tm),
            lambda r: dict(r.iterations), REFERENCE_COUNTS["compare_all"],
            compare_checks(disk))

    # (iii) the width reading
    wide = create_half_sphere(res=0.06)
    contact_record(
        dev, f"signorini (iii) half-sphere res 0.06 ({wide.mesh.num_cells} "
        f"cells), LU, first {SIGNORINI_WIDTH_STEPS} LVPP steps",
        lambda tm: solve_signorini(tagged=wide, verbose=False, device=dev,
                                   timer=tm,
                                   max_iterations=SIGNORINI_WIDTH_STEPS),
        sig_counts, REFERENCE_COUNTS["signorini_3d_0.06"],
        lambda r: [(f"{r.u.size + r.psi.size} dofs, penetrations "
                    f"{[float(f'{p:.3g}') for p in r.penetrations]} finite",
                    bool(np.isfinite(r.penetrations).all()))])

    # (iv) one Newton step under the profiler, then the bench modes
    phase_profile(dev)
    phase_bench_modes(fd_res)


def phase_profile(dev):
    """One Signorini Newton step (the half-disk at res 0.04, snes_max_it
    1: the LVPP stops after it with DIVERGED_MAX_IT) inside
    utils.profiling.device_trace inside a span of its own: the trace file
    exists and holds the span's range and the card's kernels; the step's
    seconds with and without the profiler."""
    import contextlib
    import glob
    import io
    import os
    import tempfile
    from proximalgalerkin_torch.models.signorini import solve_signorini
    from proximalgalerkin_torch.core.logging import span
    from proximalgalerkin_torch.utils.profiling import device_trace
    region = "signorini_newton_step"

    def step():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            r = solve_signorini(res=0.04, verbose=False, max_iterations=1,
                                newton_max_its=1, device=dev)
        torch.cuda.synchronize(dev)
        return r, out.getvalue()

    step()                                          # warm
    t0 = time.perf_counter()
    r, said = step()
    plain = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as logdir:
        t0 = time.perf_counter()
        with device_trace(logdir):
            with span(region):
                step()
        traced = time.perf_counter() - t0
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        check(len(files) == 1, "device_trace wrote one trace file")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") == "pg." + region
             and e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e6
    print(f"profile (iv) one Newton step of the half-disk res 0.04: "
          f"{plain:.3f} s, {traced:.3f} s under device_trace (the "
          f"profiler's own processing included); trace {size} bytes, "
          f"{len(events)} events, region {region!r} {len(marks)} time(s), "
          f"{len(kernels)} CUDA kernels, {busy:.4f} s of kernel time",
          flush=True)
    check("DIVERGED_MAX_IT" in said and r.newton_iterations == [],
          "the one-step cap stops the LVPP after its first Newton step")
    check(len(marks) >= 1, f"the trace holds the {region!r} region")
    check(len(kernels) >= 1, "the trace holds CUDA kernels")


def phase_bench_modes(fd_res=None):
    """`bench --mode stream` and `bench --mode fd -n 1024` in a child each,
    their JSON lines printed; the FD counts equal phase 8's."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    want = (FD_1025_COUNTS if fd_res is None else
            {"outer": fd_res.outer_iterations, "newton": fd_res.newton_its})
    for args in (["--mode", "stream"], ["--mode", "fd", "-n", "1024"]):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "proximalgalerkin_torch", "bench", *args],
            cwd=here, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"bench {' '.join(args)} exited {proc.returncode}:\n"
              f"{proc.stderr[-3000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        print(f"bench (iv) {' '.join(args)} ({time.perf_counter() - t0:.1f} "
              f"s in its child): {line}", flush=True)
        out = json.loads(line)
        if args[1] == "stream":
            print(f"  {out['stream_gbps'] * 1e9 / PEAK_BYTES_PER_S:.3f} of "
                  "the card's 3.35 TB/s", flush=True)
            check(all(out[k] > 0 for k in ("stream_gbps", "stream_gbps_dep",
                                           "stream_gbps_indep")),
                  "bench --mode stream rates")
        else:
            got = {"outer": out["outer"], "newton": out["newton"]}
            print(f"  counts {got}, phase 8's {want}", flush=True)
            check(out["mode"] == "fd_stencil" and got == want,
                  "bench --mode fd counts equal phase 8's")
            check(out["feasibility"] >= -1e-10, "bench --mode fd feasibility")


# ---------------------------------------------------------------- phase 14

# The distributed layer (parallel/): 8 subdomains on the card's shard axis
DIST_ND = 8
DIST_CASES = {"residual_disk0.2_P1": 1e-10, "residual_rect13x11_P2": 1e-10,
              "newton_disk0.25": 1e-10, "halo_fd_33": 1e-10}
# The JAX package's CPU records on 8 virtual devices (RESULTS.md:625-640,
# :589-594): rec_distributed_obstacle_96/_224.json (asm_btlu, Newton
# counts identical to host LU) and rec_fracture_distributed_30.json
# (MINRES on the matrix-free action)
REFERENCE_COUNTS["distributed_96"] = {"newton": [5, 4, 3]}
REFERENCE_COUNTS["distributed_224"] = {"newton": [5, 4, 3, 2]}
DIST_224_RECORD = {"dofs": 101250, "per_device_owned": 12658,
                   "ext_total": 37974, "nb_bs": [253, 151]}
REFERENCE_COUNTS["fracture_distributed"] = {
    "newton": [37, 30, 27, 25, 20, 20, 18, 16, 15, 67, 362, 93, 32, 8, 26,
               8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8],
    "lvpp": [12, 12, 12, 11, 9, 9, 8, 8, 7, 13, 24, 15, 6, 2, 5, 2, 2, 2,
             2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
    "retries": [0] * 10 + [5] + [0] * 18}
# the smoke run holds the record's first FRACTURE_DIST_STEPS load steps
# (the first 3 took 106.6 s on an H100, 37 / 94 of it the first; the
# smoke run's time limit leaves room for one); `--sizes
# fracture_distributed` runs all 29
FRACTURE_DIST_STEPS = 1
FRACTURE_DIST_OPTS = {"snes_linesearch_type": "l2", "snes_atol": 1e-6,
                      "snes_rtol": 1e-8, "snes_max_it": 50,
                      "ksp_type": "minres", "pc_type": "jacobi",
                      "mat_type": "matfree", "ksp_rtol": 1e-11,
                      "ksp_max_it": 6000}
# fd_obstacle_solve_sharded(N) on 8 virtual CPU devices, from `python
# scripts/jax_reference_records.py halo_257` (and halo_33, which the CPU
# test holds to the reference's single-device solve instead)
REFERENCE_COUNTS["halo_257"] = {"outer": 13, "newton": 20}
REFERENCE_COUNTS["halo_33"] = {"outer": 10, "newton": 17}
DIST_ASM_OPTS = {"snes_rtol": 1e-6, "snes_max_it": 50,
                 "snes_linesearch_type": "none", "ksp_type": "preonly",
                 "pc_type": "btlu", "ksp_rtol": 1e-11, "ksp_max_it": 600}
DIST_LVPP_OPTS = {"snes_rtol": 1e-6, "snes_max_it": 50,
                  "snes_linesearch_type": "none", "ksp_type": "minres",
                  "pc_type": "jacobi", "mat_type": "matfree",
                  "ksp_rtol": 1e-11, "ksp_max_it": 2000}


def _dist_obstacle(dev, mesh, comm=None):
    """The obstacle problem on `mesh` and its DistributedProblem (DIST_ND
    subdomains in this process, or `comm`'s)."""
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    from proximalgalerkin_torch.parallel.dofpart import DistributedProblem
    prob = setup_obstacle_problem(mesh, polynomial_order=1, verbose=False,
                                  device=dev)
    return prob, DistributedProblem(prob.problem, comm, n_devices=DIST_ND)


def dist_lvpp(prob, dp, opts, steps, timer=None):
    """The LVPP driver on dp (double-exponential alpha to 1e5, tol 1e-50,
    `steps` outer steps): (result, the Newton solver)."""
    from proximalgalerkin_torch.parallel.dofpart import DistributedLvppProblem
    from proximalgalerkin_torch.solve.lvpp import AlphaScheduler, LVPPSolver
    dlp = DistributedLvppProblem(dp)
    dlp.update(coeffs={"phi": dp.scatter_cellq(prob.problem.coeffs["phi"])})
    solver = LVPPSolver(
        dlp, newton_options=dict(opts),
        alpha=AlphaScheduler(scheme="double_exponential", alpha_max=1e5),
        prev_coeffs=lambda xs: {"psi_k": dp.field_to_coeff(xs, "psi"),
                                "u_k": dp.field_to_coeff(xs, "u")},
        tol=1e-50, max_iterations=steps, verbose=False, timer=timer)
    return solver.solve(dp.scatter(np.zeros(prob.space.num_dofs))), \
        solver.newton


def dist_case(name: str, dev):
    """The smallest case of each new parity test
    (tests/test_torch_dofpart.py, _parallel.py) on dev, 8 subdomains:
    (counts, fields as host arrays)."""
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    if name.startswith("residual"):
        mesh = (create_disk_mesh(0.2) if "disk" in name else
                rectangle_mesh(13, 11, p0=(-1.0, -1.0), p1=(1.0, 1.0)))
        from proximalgalerkin_torch.models.obstacle import \
            setup_obstacle_problem
        from proximalgalerkin_torch.parallel.dofpart import \
            DistributedProblem
        prob = setup_obstacle_problem(mesh, polynomial_order=int(name[-1]),
                                      verbose=False, device=dev)
        p, space = prob.problem, prob.space
        dp = DistributedProblem(p, n_devices=DIST_ND)
        rng = np.random.default_rng(7)
        x = rng.standard_normal(space.num_dofs)
        psi_k = rng.standard_normal(space.spaces["psi"].num_dofs)
        u_k = rng.standard_normal(space.spaces["u"].num_dofs)
        coeffs = {"phi": dp.scatter_cellq(p.coeffs["phi"]),
                  "psi_k": dp.scatter_coeff("psi_k", psi_k),
                  "u_k": dp.scatter_coeff("u_k", u_k)}
        xs = dp.scatter(x)
        v = np.random.default_rng(3).standard_normal(space.num_dofs)
        return ({"dofs": space.num_dofs, "Bsum": dp.Bsum,
                 "ext_total": dp.ext_total},
                {"F": dp.gather(dp.residual(xs, coeffs)),
                 "Jv": dp.gather(dp.jacobian_action(xs, dp.scatter(v),
                                                    coeffs))})
    if name == "newton_disk0.25":
        prob, dp = _dist_obstacle(dev, create_disk_mesh(0.25))
        r, _ = dist_lvpp(prob, dp, DIST_LVPP_OPTS, 3)
        return {"newton": r.newton_steps}, {"x": dp.gather(r.x)}
    if name == "halo_fd_33":
        from proximalgalerkin_torch.parallel.halo import \
            fd_obstacle_solve_sharded
        c = {}
        u, _, outer, newton = fd_obstacle_solve_sharded(
            33, device=dev, n_devices=DIST_ND, counts=c)
        return ({"outer": outer, "newton": newton,
                 "per_outer": c["newton_per_outer"]}, {"u": u})
    raise ValueError(name)


def phase_dist_cases(dev, cpu=None):
    """Phase 14 (i): the card against the CPU (counts and fields; nothing
    timed)."""
    print("== phase 14 (i): the distributed layer, card against CPU",
          flush=True)
    halo = card_vs_cpu(dev, "14", cpu)["halo_fd_33"]
    got = {k: halo[k] for k in REFERENCE_COUNTS["halo_33"]}
    print(f"halo_fd_33 counts {got}, the JAX package's sharded run "
          f"{REFERENCE_COUNTS['halo_33']}", flush=True)
    check(got == REFERENCE_COUNTS["halo_33"], "halo_fd_33 pinned counts")


class DistTally:
    """Synchronised times of the distributed Newton's parts while on
    (monkeypatched onto DistributedProblem): residuals (assembly under
    torch.func, with their exchanges), Jacobian actions (graph replays of
    the jvp or of the element-matrix action, exchanges inside), the
    cells' element matrices of the Schwarz paths, asm_btlu factors and
    applies, Jacobi diagonals; the rest of the Newton time is the Krylov
    vector work and host reads."""

    PARTS = ("residual", "jac_action", "cell_matrices", "pc_factor",
             "pc_apply", "diagonal")

    def __init__(self, dev):
        self.dev = dev
        self.secs = dict.fromkeys(self.PARTS, 0.0)
        self.calls = dict.fromkeys(self.PARTS, 0)

    def _timed(self, part, fn):
        def run(*a, **k):
            torch.cuda.synchronize(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(self.dev)
            self.secs[part] += time.perf_counter() - t0
            self.calls[part] += 1
            return out
        return run

    def __enter__(self):
        from proximalgalerkin_torch.parallel import dofpart
        DP = dofpart.DistributedProblem
        self.saved = {n: getattr(DP, n) for n in (
            "_local_residual", "_jac_operator", "_ebe_operator",
            "_cell_matrices", "_asm_btlu_pc", "_local_diagonal")}
        tally = self
        DP._local_residual = self._timed("residual",
                                         self.saved["_local_residual"])
        DP._local_diagonal = self._timed("diagonal",
                                         self.saved["_local_diagonal"])
        DP._cell_matrices = self._timed("cell_matrices",
                                        self.saved["_cell_matrices"])

        def operator(name):
            def make(dp, *a):
                return tally._timed("jac_action", tally.saved[name](dp, *a))
            return make

        def asm_btlu_pc(dp, *a, **k):
            Minv = tally._timed("pc_factor",
                                tally.saved["_asm_btlu_pc"])(dp, *a, **k)
            return tally._timed("pc_apply", Minv)

        DP._jac_operator = operator("_jac_operator")
        DP._ebe_operator = operator("_ebe_operator")
        DP._asm_btlu_pc = asm_btlu_pc
        return self

    def __exit__(self, *exc):
        from proximalgalerkin_torch.parallel import dofpart
        for n, f in self.saved.items():
            setattr(dofpart.DistributedProblem, n, f)

    def report(self, secs: float) -> str:
        rest = secs - sum(self.secs.values())
        parts = [f"{k} {100 * v / secs:.1f}% ({v:.2f} s over "
                 f"{self.calls[k]}, {1e3 * v / max(self.calls[k], 1):.3f} "
                 "ms each)" for k, v in self.secs.items() if self.calls[k]]
        return ", ".join(parts + [f"Krylov vectors and host reads "
                                  f"{100 * rest / secs:.1f}% ({rest:.2f} s)"])


def dist_record(dev, title, run, counts_of, pinned, checks_of, tally=True,
                schwarz=False):
    """One record of phase 14 (ii): run(timer) on dev, its counts held to
    `pinned` and its checks, with its seconds, the tally's shares, peak
    device memory and launches of the port's kernels (the
    element-by-element product and the block-Thomas apply where
    `schwarz`, an asm_btlu path's, none else)."""
    t = DistTally(dev)
    if tally:
        with t:
            r, secs, timer, launches, peak = timed_run(dev, run)
    else:
        r, secs, timer, launches, peak = timed_run(dev, run)
    counts = counts_of(r)
    print(f"{title}: {secs:.2f} s, counts {counts}; pinned {pinned}; peak "
          f"device memory {peak:.3f} GiB; launches {launches}", flush=True)
    if tally:
        print(f"  shares: {t.report(secs)}", flush=True)
    check(pinned is None or counts == pinned, f"{title} counts")
    for what, ok in checks_of(r):
        print(f"  {what}: {ok}", flush=True)
        check(ok, f"{title}: {what}")
    check_launches(launches, title,
                   uses=("ebe", "bt_apply") if schwarz else ())
    dist_record.launches = launches
    return r


def dist_obstacle_record(dev, n: int, steps: int, host_ref: bool):
    """rec_distributed_obstacle_n: the n^2 obstacle, 8 subdomains,
    asm_btlu under GMRES(120), `steps` LVPP steps, its counts held to the
    record's prefix; with host_ref, u held to the port's host-LU run of the
    same steps within 1e-8."""
    from proximalgalerkin_torch.mesh import rectangle_mesh
    mesh = rectangle_mesh(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    prob, dp = _dist_obstacle(dev, mesh)
    t0 = time.perf_counter()
    abt = dp._asm_btlu_setup()
    setup_s = time.perf_counter() - t0
    N = prob.space.num_dofs
    u_sl = prob.space.slice_of("u")
    nwt = []
    checks = []
    if host_ref:
        t0 = time.perf_counter()
        ref = prob.solver          # the reference's default: host LU
        ref.max_iterations, ref.tol, ref.verbose = steps, 1e-50, False
        rref = ref.solve(torch.zeros(N, dtype=torch.float64, device=dev))
        print(f"  host-LU reference: Newton {rref.newton_steps}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        u_ref = rref.x[u_sl].cpu().numpy()

        def checks(r):
            d = float(np.abs(dp.gather(r.x)[u_sl] - u_ref).max())
            return [(f"max |u - u_hostLU| {d:.3e} < 1e-8", d < 1e-8)]
    else:
        def checks(r):
            return []

    def run(tm):
        r, newton = dist_lvpp(prob, dp, DIST_ASM_OPTS, steps, tm)
        nwt.append(newton)
        return r

    pinned = {"newton": REFERENCE_COUNTS[f"distributed_{n}"]["newton"][
        :steps]}
    r = dist_record(
        dev, f"distributed obstacle {n}^2 ({N:,} dofs), 8 subdomains, "
        f"asm_btlu GMRES(120), {steps} LVPP steps", run,
        lambda r: {"newton": r.newton_steps}, pinned, checks,
        schwarz=True)
    its = nwt[0].krylov_its
    print(f"  GMRES iterations an LVPP step {its}; per-subdomain owned "
          f"dofs {dp.Bsum} (record {DIST_224_RECORD['per_device_owned']} at "
          f"224^2), ext_total {dp.ext_total} (record "
          f"{DIST_224_RECORD['ext_total']}), nb x bs {abt['nb']} x "
          f"{abt['bs']} (record {DIST_224_RECORD['nb_bs']}), factor "
          f"{dp.asm_btlu_factor_bytes() / 2**20:.1f} MiB a subdomain, "
          f"blocking set-up {setup_s:.1f} s", flush=True)
    dist_action_timings(dev, prob, dp)
    return dp, abt


def dist_action_timings(dev, prob, dp):
    """ms of one Jacobian action on dp's subdomains (at the LVPP start
    state, alpha 1): the jvp eager and replayed as a CUDA graph, the
    element-matrix action of the Schwarz paths replayed as a CUDA graph
    (held to the jvp within 1e-13 relative), and of one exchange pair
    (forward ghost gather + reverse fold): per_call_ms, CUDA events
    around 10 calls; and the device operations of one replay of each
    graph (torch.profiler over 5)."""
    N = prob.space.num_dofs
    coeffs = dp._prep_coeffs({
        "phi": dp.scatter_cellq(prob.problem.coeffs["phi"]),
        "psi_k": dp.scatter_coeff("psi_k", np.zeros(
            prob.space.spaces["psi"].num_dofs)),
        "u_k": dp.scatter_coeff("u_k", np.zeros(
            prob.space.spaces["u"].num_dofs))})
    consts = {"alpha": torch.tensor(1.0, dtype=torch.float64, device=dev)}
    x = dp.scatter(np.zeros(N))
    v = dp.scatter(np.random.default_rng(SEED).standard_normal(N))
    Ae = dp._cell_matrices(x, coeffs, consts)
    ops = {"graph": dp._jac_operator(x, coeffs, {}, consts, dp.bc_mask),
           "eager": dp._jac_action(x, coeffs, {}, consts, dp.bc_mask),
           "ebe_graph": dp._ebe_operator(x, Ae, {}, consts, dp.bc_mask)}
    err = rel_max(ops["ebe_graph"](v), ops["eager"](v))
    out = {name: per_call_ms(lambda: Av(v), calls=10)
           for name, Av in ops.items()}
    out["exchange"] = per_call_ms(
        lambda: dp._reverse_fold(dp._forward_ext(v)), calls=10)
    nops = {name: device_ops(lambda: ops[name](v))
            for name in ("graph", "ebe_graph")}
    print(f"  one Jacobian action: jvp eager {out['eager']:.3f} ms, jvp "
          f"CUDA graph {out['graph']:.3f} ms ({nops['graph']} device "
          f"operations), element matrices CUDA graph "
          f"{out['ebe_graph']:.3f} ms ({nops['ebe_graph']} device "
          f"operations; max rel diff from the jvp {err:.2e}); one "
          f"exchange pair {out['exchange']:.3f} ms", flush=True)
    check(err <= 1e-13, "element-matrix action within 1e-13 of the jvp")
    return out


def device_ops(fn, calls: int = 5) -> float:
    """Device operations (kernels, copies, fills) per call of fn, from
    torch.profiler over `calls` calls after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / calls


def fracture_dist_record(dev, steps: int):
    """rec_fracture_distributed_30: the fracture continuation at res 0.1,
    8 subdomains, MINRES on the matrix-free action, its first `steps`
    load steps held to the record's counts."""
    from proximalgalerkin_torch.models import fracture
    ref = REFERENCE_COUNTS["fracture_distributed"]
    return dist_record(
        dev, f"distributed fracture res 0.1, 8 subdomains, MINRES/jacobi "
        f"matrix-free, first {steps} of 29 load steps",
        lambda tm: fracture.solve_fracture(
            max_res=0.1, Tmin=0.0,
            Tmax=float(np.linspace(0.0, 3.0, 30)[steps]),
            num_load_steps=steps + 1, solver_options=FRACTURE_DIST_OPTS,
            n_devices=DIST_ND, verbose=False, device=dev, timer=tm),
        lambda r: {"newton": r.newton_per_step, "lvpp": r.lvpp_per_step,
                   "retries": r.retries_per_step},
        {k: v[:steps] for k, v in ref.items()},
        lambda r: [(f"c in (-0.05, 1.1) ([{r.c.min():.4f}, "
                    f"{r.c.max():.4f}])",
                    r.c.min() > -0.05 and r.c.max() < 1.1)])


def halo_record(dev, N: int, pinned=None):
    """fd_obstacle_solve_sharded(N) on 8 strips: its counts (held to
    `pinned` when given), CG total, seconds and min(u - phi)."""
    from proximalgalerkin_torch.parallel.halo import \
        fd_obstacle_solve_sharded
    c = {}
    r = dist_record(
        dev, f"halo-exchange FD obstacle N={N}, 8 strips",
        lambda tm: fd_obstacle_solve_sharded(N, device=dev,
                                             n_devices=DIST_ND, counts=c),
        lambda r: {"outer": r[2], "newton": r[3]},
        pinned, lambda r: [(f"min(u - phi) {float(np.min(r[0] - r[1])):.3e}"
                            " >= -1e-8", float(np.min(r[0] - r[1]))
                            >= -1e-8)], tally=False)
    print(f"  Newton per outer {c['newton_per_outer']}, CG {c['cg_its']}",
          flush=True)
    return r


def phase_multiprocess(dev):
    """Phase 14 (iii): init_multihost on NCCL at world size 1 on the card;
    the disk-0.25 obstacle with 4 subdomains through that process group
    (its psums all_gather over NCCL) bit for bit equal to the in-process
    ShardComm run, both under deterministic algorithms."""
    import socket
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_torch.parallel.comm import ShardComm, world_comm
    from proximalgalerkin_torch.parallel.multihost import (init_multihost,
                                                           shutdown)
    print("== phase 14 (iii): multi-process start-up on NCCL", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rank, world, devs = init_multihost(f"127.0.0.1:{port}", 1, 0,
                                       device="cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        check((rank, world) == (0, 1) and devs == [dev],
              f"init_multihost gave {(rank, world, devs)}")
        out = {}
        for tag, comm in (("in-process", ShardComm(4, dev)),
                          ("NCCL group", world_comm(4, dev))):
            prob, dp = _dist_obstacle(dev, create_disk_mesh(0.25), comm)
            t0 = time.perf_counter()
            r, _ = dist_lvpp(prob, dp, DIST_LVPP_OPTS, 3)
            x = dp.gather(r.x)
            out[tag] = (r.newton_steps, x)
            print(f"  {tag}: Newton {r.newton_steps}, ||x|| "
                  f"{np.linalg.norm(x):.15e}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        (c0, x0), (c1, x1) = out.values()
        check(c0 == c1, "NCCL counts")
        check(np.array_equal(x0, x1), "NCCL run bit for bit")
        print("  bit for bit: True", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        shutdown()
    n = torch.cuda.device_count()
    if n >= 2:
        print(f"  {n} cards: the 2-process x 1-card run is "
              "tests/test_torch_gpu.py::test_two_card_nccl_lvpp", flush=True)
    else:
        print("  one card: only world size 1 ran (NCCL takes one card a "
              "process)", flush=True)


def phase_distributed(dev) -> tuple:
    """Phase 14 (ii)-(v); returns the element-by-element kernel's and the
    block-Thomas apply kernel's timings, each with its launches in the
    224^2 record."""
    print("== phase 14 (ii): the distributed records", flush=True)
    t0 = time.perf_counter()
    dist_obstacle_record(dev, 96, 3, host_ref=True)
    print(f"-- 96^2 record {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dp, abt = dist_obstacle_record(dev, 224, 1, host_ref=False)
    launches = dist_record.launches
    print(f"-- 224^2 first step {time.perf_counter() - t0:.1f} s",
          flush=True)
    timing = phase_ebe(dev, dp._ebe_index()[0], dp.nloc * dp.ext_total)
    bt_timing = phase_bt_apply(dev, dp.nloc, abt["nb"], abt["bs"])
    del dp
    t0 = time.perf_counter()
    fracture_dist_record(dev, FRACTURE_DIST_STEPS)
    print(f"-- fracture {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    halo_record(dev, 257, REFERENCE_COUNTS["halo_257"])
    print(f"-- halo 257 {time.perf_counter() - t0:.1f} s", flush=True)
    phase_multiprocess(dev)
    return (dict(timing, launches=launches["ebe"]),
            dict(bt_timing, launches=launches["bt_apply"]))


def ebe_system(dev, ne: int, L: int, n: int, seed: int, gidx=None):
    """An element-by-element product's inputs on dev: A (ne, L, L) and x
    (n,) standard normal from seed, gidx (ne, L) int32 given or uniform
    in [0, n)."""
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((ne, L, L)), device=dev)
    if gidx is None:
        gidx = torch.as_tensor(rng.integers(0, n, (ne, L)),
                               dtype=torch.int32, device=dev)
    x = torch.as_tensor(rng.standard_normal(n), device=dev)
    return A, gidx, x


def ebe_bytes(ne: int, L: int, n: int) -> int:
    """What an element-by-element product reads and writes once: A, the
    int32 gathers, x, y."""
    return ne * L * L * 8 + ne * L * 4 + 2 * n * 8


def phase_ebe(dev, gidx, n: int) -> dict:
    """Phase 14 (iv): the element-by-element product kernel against its
    plain version at the 224^2 cell's shapes (gidx, n: its cells'
    gathers and stacked extended vectors, random A and x) and at a vector
    field's L = 9 (random gathers), within 1e-13 relative (the kernel
    adds a row's sum with an atomic, in no fixed order); the kernel's
    device time a launch (torch.profiler over 50) beside its bound and
    the plain version's time a call (CUDA events). Returns the cell
    shape's timing."""
    print("== phase 14 (iv): the element-by-element product kernel against "
          "its plain version", flush=True)
    from proximalgalerkin_torch.ops.ebe import ebe_apply, ebe_apply_reference
    timing = {}
    ne, L = (int(d) for d in gidx.shape)
    for label, (A, g, x) in (
            ("224^2 cell", ebe_system(dev, ne, L, n, SEED + 7, gidx)),
            ("vector field", ebe_system(dev, 50_000, 9, 150_000,
                                        SEED + 8))):
        ne_, L_, n_ = int(A.shape[0]), int(A.shape[1]), int(x.shape[0])
        yk, yp = ebe_apply(A, g, x, n_), ebe_apply_reference(A, g, x, n_)
        err = rel_max(yk, yp)
        ms_k = device_ms(lambda: ebe_apply(A, g, x, n_),
                         ["k_ebe_apply"])["k_ebe_apply"]
        call_k = per_call_ms(lambda: ebe_apply(A, g, x, n_))
        ms_p = per_call_ms(lambda: ebe_apply_reference(A, g, x, n_))
        nbytes = ebe_bytes(ne_, L_, n_)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        print(f"ebe {label} ne={ne_} L={L_} n={n_}: max rel diff {err:.3e} "
              f"(bound 1e-13); kernel {ms_k:.4f} ms device ({call_k:.4f} ms "
              f"per call with y's zero fill), plain {ms_p:.4f} ms per call "
              f"(median of 3 runs of 50); bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
              f"{100 * bound_ms / ms_k:.1f}% of it", flush=True)
        check(err <= 1e-13, f"ebe {label}")
        if not timing:
            timing = {"max_rel_err": err, "ms": ms_k, "plain_ms": ms_p,
                      "bound_ms": bound_ms, "bound_by": "bytes"}
    return timing


def bt_system(dev, S, nb: int, bs: int, dtype, seed: int):
    """A block-Thomas apply's inputs on dev: Minv (S, nb, bs, bs), T and L
    (S, nb - 1, bs, bs) with standard normal entries scaled by 0.25 /
    sqrt(bs) (norms about 0.5, so the substitution contracts), b (S, nb,
    bs) standard normal; from a generator on dev seeded with seed. S None:
    no batch axis."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lead = () if S is None else (S,)

    def randn(*shape, scale=1.0):
        return torch.randn(lead + shape, generator=g, dtype=torch.float64,
                           device=dev).mul_(scale).to(dtype)

    sc = 0.25 / bs ** 0.5
    return (randn(nb, bs, bs, scale=sc), randn(nb - 1, bs, bs, scale=sc),
            randn(nb - 1, bs, bs, scale=sc), randn(nb, bs))


def bt_bytes(S: int, nb: int, bs: int, isz: int) -> int:
    """What a block-Thomas apply reads and writes once: the factor's
    3 nb - 2 blocks, b and x."""
    return S * ((3 * nb - 2) * bs * bs + 2 * nb * bs) * isz


def phase_bt_apply(dev, S: int, nb: int, bs: int) -> dict:
    """Phase 14 (v): the block-Thomas apply kernel (csrc/btapply.cu)
    against its plain version (la/blocktri.bt_apply_reference) at the
    distributed cell's shapes (S subdomains, nb x bs: 8, 253, 151) and the
    disk cell's (1, 97, 200) in f64, on bt_system's random factors: within
    1e-12 relative to max |x| (another sum order, through factors that
    contract), two launches bit for bit equal; its device time a launch
    (torch.profiler over 20) beside its bound (the factor, b and x once at
    3.35 TB/s) and the plain version's time a call (CUDA events), with
    its launch geometry. Returns the distributed shape's timing."""
    print("== phase 14 (v): the block-Thomas apply kernel against its "
          "plain version", flush=True)
    from proximalgalerkin_torch.la.blocktri import bt_apply_reference
    from proximalgalerkin_torch.ops import btapply
    timing = {}
    for label, shape in (("distributed cell", (S, nb, bs)),
                         ("disk cell", (1, 97, 200))):
        Minv, T, L, b = bt_system(dev, *shape, torch.float64, SEED + 9)
        before = btapply.bt_apply.launches
        xk = btapply.bt_apply(Minv, T, L, b)
        xk2 = btapply.bt_apply(Minv, T, L, b)
        xp = bt_apply_reference(Minv, T, L, b)
        torch.cuda.synchronize()
        err = rel_max(xk, xp)
        same = bool(torch.equal(xk, xk2))
        ms_k = device_ms(lambda: btapply.bt_apply(Minv, T, L, b),
                         ["k_bt_apply"], calls=20)["k_bt_apply"]
        ms_p = per_call_ms(lambda: bt_apply_reference(Minv, T, L, b),
                           calls=5)
        nbytes = bt_bytes(*shape, 8)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        geo = btapply.plan(*shape, torch.float64, dev)
        print(f"bt_apply {label} S={shape[0]} nb={shape[1]} bs={shape[2]} "
              f"f64: max rel diff {err:.3e} (bound 1e-12), two launches "
              f"equal {same}; kernel {ms_k:.4f} ms device, plain "
              f"{ms_p:.4f} ms per call (median of 3 runs of 5); bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
              f"{100 * bound_ms / ms_k:.1f}% of it; {3 * shape[1] - 2} "
              f"dependent products; geometry {geo}; launches "
              f"{btapply.bt_apply.launches - before}", flush=True)
        check(err <= 1e-12, f"bt_apply {label}")
        check(same, f"bt_apply {label}: two launches bit for bit")
        if not timing:
            timing = {"max_rel_err": err, "ms": ms_k, "plain_ms": ms_p,
                      "bound_ms": bound_ms, "bound_by": "bytes"}
        del Minv, T, L, b, xk, xk2, xp
    return timing


BTLU_LABEL = "gradient 12^2 P2 btlu "
# the (i) cases whose direction applies a dense block-Thomas factor on the
# card, with the kernel of ops/btapply (cyclic reduction and the streamed
# layout keep their own applies)
BT_KERNEL_CASES = {BTLU_LABEL + "thomas_f32",
                   BTLU_LABEL + "lagged_f64_f32apply",
                   "multiphase N=10 fused_btlu"}


def case_group(group: str) -> list:
    """The card-against-CPU checks of phase `group` (i), in order:
    (label, name, fn, bound) each, fn(name, dev) -> (counts, fields as
    host arrays), bound on max |card - cpu| / max |cpu| of each field."""
    if group == "10":
        return [("", n, model_case, field_rtol(n)) for n in MODELS]
    if group == "11":
        return ([(BTLU_LABEL, n, btlu_case, 1e-10) for n in BTLU_CASES]
                + [("multiphase N=10 ", n, multiphase_case, 1e-10)
                   for n in MULTIPHASE_CASES])
    if group == "13":
        return [("", n, contact_case, 1e-10) for n in CONTACT_CASES]
    if group == "14":
        return [("", n, dist_case, b) for n, b in DIST_CASES.items()]
    return [("", n, schur_case, b) for n, b in SCHUR_CASES.items()]


def cpu_cases(group: str) -> dict:
    """The CPU halves of case_group(group), torch on one intra-op thread
    (they are thousands of small ops, which torch's thread pool slows many
    times over beside the smoke run's other processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {label + name: fn(name, torch.device("cpu"))
                for label, name, fn, _ in case_group(group)}
    finally:
        torch.set_num_threads(threads)


def card_vs_cpu(dev, group: str, cpu=None) -> dict:
    """The (i) checks of case_group(group): every case on dev, then on the
    CPU (cpu: a CpuCases child that computes them meanwhile; None: here,
    after the card): counts equal, fields within the case's bound, no
    launch of the port's CUDA kernels. Returns the card's counts."""
    cases = case_group(group)
    card = {}
    for label, name, fn, _ in cases:
        t0 = time.perf_counter()
        reset_counters()
        counts, fields = fn(name, dev)
        card[label + name] = (counts, fields, read_counters(),
                              time.perf_counter() - t0)
    on_cpu = cpu_cases(group) if cpu is None else cpu.result()
    for label, name, _, bound in cases:
        what = f"{label}{name} (i)"
        c_card, f_card, launches, secs = card[label + name]
        c_cpu, f_cpu = on_cpu[label + name]
        dmax = max(rel_field(f_card[k], f_cpu[k]) for k in f_card)
        print(f"{what} card vs cpu: counts {c_card} vs {c_cpu}, max "
              f"relative field difference {dmax:.3e} (bound {bound:.0e}), "
              f"{secs:.1f} s on the card", flush=True)
        check(c_card == c_cpu, f"{what} counts")
        check(dmax <= bound, f"{what} fields")
        check_launches(launches, what, uses=(
            ("bt_apply",) if label + name in BT_KERNEL_CASES else ()))
    return {k: v[0] for k, v in card.items()}


class CpuCases:
    """cpu_cases(group) in a child process (`chip_smoke.py --cpu-cases
    GROUP OUT`, the results pickled to OUT), started beside the card
    halves; result() waits and returns them, stop() ends the child if it
    still runs."""

    def __init__(self, group: str):
        import os
        import tempfile
        fd, self.path = tempfile.mkstemp(suffix=".pkl")
        os.close(fd)
        self.group = group
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-cases",
             group, self.path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self) -> dict:
        import pickle
        out, err = self.proc.communicate(timeout=1200)
        check(self.proc.returncode == 0, f"the CPU cases of phase "
              f"{self.group} exited {self.proc.returncode}:\n{err}")
        print(f"phase {self.group} (i): the CPU halves took "
              f"{out.strip().splitlines()[-1]} s in their child", flush=True)
        with open(self.path, "rb") as f:
            return pickle.load(f)

    def stop(self):
        import os
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if os.path.exists(self.path):
            os.remove(self.path)


class RecordProcess:
    """MULTIPHASE_RECORDS[key], the eikonal ball (key "eikonal_ball") or
    the btlu records' depth cuts (key "btlu_cuts") in a child process on
    the same card (`chip_smoke.py --record KEY`). The smoke run starts one
    for phase 11 (iv), 75 host SuperLU factors, one for phase 11 (vi) and
    one for phase 12 (ii)'s ball, host SuperLU too, beside the
    card-against-CPU checks of phases 10 (i)-14 (i), which time nothing,
    and waits for them before any other timed run. result() waits and
    returns the readings of the child's last line, with the lines it
    printed before as "out"; stop() ends it if it still runs."""

    def __init__(self, key: str):
        import os
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--record", key],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self) -> dict:
        out, err = self.proc.communicate(timeout=1200)
        check(self.proc.returncode == 0,
              f"the record process exited {self.proc.returncode}:\n{err}")
        lines = out.strip().splitlines()
        return json.loads(lines[-1]) | {"out": "\n".join(lines[:-1])}

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def ab_child(pc: str, out: str):
    """One 1024^2 mixed solve with `pc` of the package in the working
    directory (after a warm-up solve); saves u to `out` and prints one
    JSON line."""
    import os
    sys.path.insert(0, os.getcwd())
    # this file imported the package beside it: take the working
    # directory's instead
    for name in [k for k in sys.modules
                 if k.split(".")[0] == "proximalgalerkin_torch"]:
        del sys.modules[name]
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
    from proximalgalerkin_torch.ops import dia_spmv, mgfused
    mgfused.build()
    dia_spmv.build()
    dev = torch.device("cuda", 0)
    mesh = rectangle_mesh(1024, 1024, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    solver = P1ObstacleSolver(mesh, device=dev, alpha_cap=1e2,
                              outer_tol=1e-8, mixed_precision=True, pc=pc)
    solver.solve()
    inner = InnerTimer("mgfused" if pc == "mg" else "dia_cg")
    t0 = time.perf_counter()
    with inner:
        res = solver.solve()
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    _, wall, busy, _ = busy_profile(lambda: solver.solve(max_outer=1))
    np.save(out, res.u)
    chain = tail_chain(dev) if pc == "mg" else None
    print(json.dumps({
        "package": mgfused.__file__, "pc": pc, "solve_s": elapsed,
        "tail_chain": chain,
        "u_sha256": hashlib.sha256(res.u.tobytes()).hexdigest()[:16],
        "inner_ms": inner.ms, "cg": res.cg_its_total,
        "ms_per_cg_iteration": inner.ms / inner.its,
        "outer": res.outer_iterations, "newton": res.newton_its,
        "newton_per_outer": res.newton_per_outer,
        "feasibility": float((res.u - solver.phi.cpu().numpy()).min()),
        "idle_share_outer1": 1 - busy / wall}))


def ab(parent: str):
    """parent, this, this, parent: the 1024^2 mg solve of each, then the
    jacobi solve of each, every one in its own process, on this card. The
    counts and the bits of u must not depend on the package, and the
    jacobi solution must agree with the mg one."""
    import os
    import tempfile
    phase_card()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "u.npy")
        u_mg = None
        for pc in ("mg", "jacobi"):
            runs = []
            for label, root in (("parent", parent), ("this", here),
                                ("this", here), ("parent", parent)):
                proc = subprocess.run(
                    [sys.executable, os.path.join(here, "chip_smoke.py"),
                     "--ab-child", pc, out], cwd=os.path.abspath(root),
                    capture_output=True, text=True, timeout=900)
                check(proc.returncode == 0,
                      f"A/B run in {root}:\n{proc.stderr}")
                line = proc.stdout.strip().splitlines()[-1]
                print(f"A/B {pc} {label}: {line}", flush=True)
                runs.append(json.loads(line))
                check(runs[-1]["package"].startswith(os.path.abspath(root)),
                      f"A/B run in {root} took its own package")
            u = np.load(out)
            if pc == "mg":
                u_mg = u
            rel = float(np.linalg.norm(u - u_mg) / np.linalg.norm(u_mg))
            same = all(r[k] == runs[0][k] for r in runs
                       for k in ("cg", "newton_per_outer", "u_sha256"))
            print(f"A/B {pc}: counts and u bitwise equal in all four {same}; "
                  f"min feasibility {min(r['feasibility'] for r in runs):.3e}"
                  f" (bound -1e-10); |u - u_mg|/|u_mg| {rel:.3e} (bound "
                  "1e-6)", flush=True)
            check(same, f"A/B {pc}: counts and bits of u")
            check(all(r["feasibility"] >= -1e-10 for r in runs)
                  and rel <= 1e-6, f"A/B {pc}: feasibility and solution")


MATFREE = {"ksp_type": "minres", "pc_type": "jacobi", "mat_type": "matfree",
           "ksp_rtol": 1e-9, "ksp_max_it": 4000, "snes_rtol": 1e-8,
           "snes_max_it": 50}
# The JAX package's CPU Newton counts of the eikonal 24x4 with MATFREE
# (tests/test_eikonal.py:69-82), its first 5 LVPP steps
MATFREE_NEWTON_5 = [2, 2, 3, 3, 2]
SIZES = ("lvpp", "fd", "models", "multiphase", "first_steps",
         "gradient_lvpp", "eikonal_matfree", "signorini_width",
         "distributed_224", "fracture_distributed", "halo_fd_1025",
         "unstructured_101k", "eigenvalue_100_streamed", "gradient_200_btlu")


def sizes(names=SIZES):
    """The measurements that fixed the sizes of phases 8-12 (`--sizes
    [NAME ...]`, each NAME of SIZES, all by default): phase 9 at 224^2
    and 160^2 (lvpp), phase 8 at N = 1025 and 513 (fd); the CLI-size runs
    of three models (models): thermoforming at M = 150, the whole 29-step
    fracture record, and eigenvalue at N = 100 P3 cut to its first Newton
    step (one assembly, one nested-dissection SuperLU factor of the
    362,404-dof system); the whole 5-step 24^2 multiphase record
    (multiphase; phase 11 (iv) runs its first step); phase 12 (iv)'s
    first Newton step of the N^2 gradient constraint at N = 64, 96, 128
    and 200, refined and with no refinement pass (at 200^2 held on
    either side of GRADIENT_200_RESIDUAL; first_steps), and its
    first LVPP step at 200^2 (gradient_lvpp); the eikonal 24x4 with
    MINRES on the matrix-free Jacobian (MATFREE), its first 5 LVPP steps,
    beside LU (eikonal_matfree); the whole Signorini trajectory of the
    half-sphere at res 0.06, with LU, whose first SIGNORINI_WIDTH_STEPS
    LVPP steps phase 13 (iii) runs (signorini_width); the 224^2
    distributed obstacle's 4 LVPP steps (distributed_224), the
    distributed fracture's 29 load steps (fracture_distributed) and
    fd_obstacle_solve_sharded(1025) on 8 strips (halo_fd_1025), of
    phase 14 (ii); the JAX package's three all-device btlu records, each
    whole (BTLU_RECORDS: unstructured_101k, eigenvalue_100_streamed,
    gradient_200_btlu)."""
    phase_card()
    dev = torch.device("cuda", 0)
    for name in BTLU_RECORDS:
        if name in names:
            btlu_record(dev, name)
    if "lvpp" in names:
        for n in (224, 160):
            t0 = time.perf_counter()
            phase_lvpp(dev, n)
            print(f"phase 9 at {n}^2: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    if "fd" in names:
        for N in (1025, 513):
            t0 = time.perf_counter()
            phase_fd(dev, N)
            print(f"phase 8 at N={N}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    if "models" in names:
        sizes_models(dev)
    if "multiphase" in names:
        report_multiphase(multiphase_record("multiphase_24_full", dev))
    if "first_steps" in names:
        for N in (64, 96, 128):
            for refine_max in (None, 0):
                r = schur_record(
                    dev, f"gradient {N}^2 P2, schur_mg mixed, ksp_refine_max "
                    f"{30 if refine_max is None else refine_max}, first "
                    "Newton step", lambda tm, N=N, k=refine_max:
                    gradient_first_step(dev, tm, N, refine_max=k),
                    lambda r: {k: r[k] for k in GRADIENT_FIRST_STEP},
                    GRADIENT_FIRST_STEP, lambda r: [])
                print(f"  |J dx + F| / |F| {direction_residual(r):.3e}, "
                      f"|F(x1)| / |F(x0)| {r['fratio']:.3e}", flush=True)
        first_step_record(dev, 200)
        first_step_record(dev, 200, refine_max=0)
    if "gradient_lvpp" in names:
        from proximalgalerkin_torch.models import gradient_constraint
        schur_record(
            dev, "gradient 200^2 P2, schur_mg mixed, first LVPP step",
            lambda tm: gradient_constraint.solve_gradient_constraint(
                max_iterations=1, verbose=True, device=dev, timer=tm,
                solver_options=GRADIENT_SCHUR_MG, **GRADIENT_200)[1],
            lambda r: {"newton": r.newton_steps}, {"newton": [5]},
            lambda r: [])
    if "eikonal_matfree" in names:
        from proximalgalerkin_torch.models.eikonal import solve_eikonal
        kw = dict(ns=24, nt=4, max_iterations=5, verbose=False, device=dev)
        lu = solve_eikonal(**kw)
        schur_record(
            dev, "eikonal 24x4, MINRES on the matrix-free Jacobian, first "
            "5 LVPP steps", lambda tm: solve_eikonal(
                timer=tm, solver_options=MATFREE, **kw),
            lambda r: {"newton": r.newton_iterations},
            {"newton": MATFREE_NEWTON_5},
            lambda r: [(f"max |u - u_LU| {np.abs(r.u - lu.u).max():.2e} < "
                        "1e-6", np.abs(r.u - lu.u).max() < 1e-6)])
    if "distributed_224" in names:
        dist_obstacle_record(dev, 224, 4, host_ref=False)
    if "fracture_distributed" in names:
        fracture_dist_record(dev, 29)
    if "halo_fd_1025" in names:
        halo_record(dev, 1025)
    if "signorini_width" in names:
        from proximalgalerkin_torch.mesh.parametric import create_half_sphere
        from proximalgalerkin_torch.models.signorini import solve_signorini
        wide = create_half_sphere(res=0.06)
        r, secs, timer, launches, peak = timed_run(
            dev, lambda tm: solve_signorini(tagged=wide, verbose=True,
                                            device=dev, timer=tm))
        print(f"signorini half-sphere res 0.06, LU, whole trajectory: "
              f"{secs:.1f} s, LVPP {r.lvpp_iterations}, Newton "
              f"{r.newton_iterations}, converged {r.converged}, final "
              f"penetration {r.penetrations[-1]:.3e}; peak device memory "
              f"{peak:.3f} GiB; launches {launches}; PhaseTimer:\n  "
              + timer.report().replace("\n", "\n  "), flush=True)


def sizes_models(dev):
    """The three models of sizes() at their CLI sizes, each with its
    seconds, counts, peak device memory and PhaseTimer report."""
    from proximalgalerkin_torch.core.logging import PhaseTimer
    from proximalgalerkin_torch.models import (eigenvalue_constraints,
                                               fracture, thermoforming)
    runs = (
        ("thermoforming M=150", lambda tm: thermoforming.solve_thermoforming(
            M=150, verbose=False, device=dev, timer=tm),
         lambda r: f"LVPP {r.lvpp_iterations}, Newton {r.total_newton}, "
                   f"converged {r.converged}"),
        ("fracture res 0.1, 29 load steps", lambda tm: fracture.solve_fracture(
            max_res=0.1, Tmin=0.0, Tmax=3.0, num_load_steps=30,
            verbose=False, device=dev, timer=tm),
         lambda r: f"Newton {r.newton_per_step} (total "
                   f"{sum(r.newton_per_step)}), LVPP {r.lvpp_per_step}, "
                   f"retries {r.retries_per_step}, broken {r.broken}"),
        # SuperLU's own ordering runs out of memory on this system (RESULTS.md
        # :83-86); the reference's record used nested dissection
        ("eigenvalue N=100 P3, first Newton step, nested-dissection LU",
         lambda tm: eigenvalue_constraints.solve_eigenvalue_constraints(
             N=100, degree=3, max_lvpp=1, nfail_max=0,
             solver_options={"snes_max_it": 1, "pc_factor_ordering": "nd"},
             verbose=False, device=dev, timer=tm),
         lambda r: f"dofs {4 * r.q1.size}"),
    )
    for title, run, describe in runs:
        timer = PhaseTimer(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        r = run(timer)
        torch.cuda.synchronize(dev)
        print(f"{title}: {time.perf_counter() - t0:.1f} s, {describe(r)}, "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              "PhaseTimer:\n  " + timer.report().replace("\n", "\n  "),
              flush=True)


# The JAX package's three all-device btlu records (scripts/tpu_records.py,
# their counts logged in records/), each run whole by `--sizes NAME`:
# (title, its run(dev, timer, cut) -> (counts, converged, extra checks),
# the pinned counts). The option sets are the record script's
# device_direct(): btlu with its f32 factor and ksp_rtol 1e-9, the disk
# with the f64 factor, the recursive block-Schur inverse
# (pc_factor_blockinv 'schur'), lag 1 and ksp_rtol 1e-12; the eigenvalue
# record's factor is streamed because its dense factors exceed
# LineBlocking.max_bytes, the record script's 11e9. `cut` runs the depth
# cut of the default run: the disk's first LVPP step, the eigenvalue's
# first Newton step.
DEVICE_DIRECT = {"ksp_type": "preonly", "pc_type": "btlu", "ksp_rtol": 1e-9}


def _disk_record(dev, timer, cut):
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    prob = setup_obstacle_problem(
        create_disk_mesh(res=0.0085), polynomial_order=1, tol_exit=1e-8,
        alpha_max=1e4, maximum_number_of_outer_loop_iterations=1 if cut
        else 60, verbose=True, device=dev, solver_options={
            **DEVICE_DIRECT, "pc_factor_dtype": "f64",
            "pc_factor_blockinv": "schur", "pc_factor_lag": 1,
            "ksp_rtol": 1e-12})
    prob.solver.timer = prob.solver.newton.timer = timer
    r = prob.solve()
    return ({"lvpp": r.iterations, "newton": r.newton_steps}, r.converged,
            [(f"dofs {prob.space.num_dofs} == 101000",
              prob.space.num_dofs == 101000)])


def _eigenvalue_record(dev, timer, cut):
    from proximalgalerkin_torch.models.eigenvalue_constraints import \
        solve_eigenvalue_constraints
    r = solve_eigenvalue_constraints(
        N=100, degree=3, verbose=True, device=dev, timer=timer,
        **(dict(max_lvpp=1, nfail_max=0) if cut else {}),
        solver_options={**DEVICE_DIRECT,
                        **({"snes_max_it": 1} if cut else {})})
    lo, hi = r.eigenvalue_range()
    counts = {"lvpp": r.lvpp.iterations,
              "newton": int(sum(r.lvpp.newton_steps))}
    if cut:
        # the capped step is a failed LVPP step, so it is counted by its
        # directions, not in newton_steps
        return ({"lvpp": r.lvpp.iterations,
                 "newton": timer.counts.get("linear_solve_bt", 0)}, True,
                [(f"dofs {4 * r.q1.size} == 362404",
                  4 * r.q1.size == 362404)])
    return counts, r.lvpp.converged, [
        (f"lambda in [{lo:.12f}, {hi:.12f}], within 1e-6 of [-0.5, 0.5]",
         abs(lo + 0.5) <= 1e-6 and abs(hi - 0.5) <= 1e-6)]


def _gradient_record(dev, timer, cut):
    from proximalgalerkin_torch.models.gradient_constraint import \
        solve_gradient_constraint
    _, r = solve_gradient_constraint(
        verbose=True, device=dev, timer=timer, solver_options=DEVICE_DIRECT,
        **GRADIENT_200)
    return ({"lvpp": r.iterations, "newton": int(sum(r.newton_steps))},
            r.converged, [(f"last increment {r.increments[-1]:.3e} < 1e-8",
                           r.increments[-1] < 1e-8)])


BTLU_RECORDS = {
    # records/rec_obstacle_unstructured_dev.log (scripts/tpu_records.py
    # :254-294): 101,000 dofs, the record's blocking nb 272 x bs 562 (the
    # JAX package's today, as the port's: 273 x 566)
    "unstructured_101k": (
        "example 01's disk at res 0.0085, btlu f64 factor, lag 1, ksp_rtol "
        "1e-12, alpha_max 1e4, tol 1e-8", _disk_record,
        {"lvpp": 13, "newton": [5, 4, 3, 2] + [1] * 9}),
    # records/eigenvalue_btlu_run.log (:175-193): 362,404 dofs
    "eigenvalue_100_streamed": (
        "eigenvalue constraints 100^2 P3, streamed btlu f32 factor",
        _eigenvalue_record, {"lvpp": 7, "newton": 16}),
    # records/rec_gradient_200_btlu.log (:138-146): 241,603 dofs, last
    # increment 6.5e-9
    "gradient_200_btlu": (
        "gradient constraint 200^2 P2, btlu f32 factor",
        _gradient_record, {"lvpp": 17, "newton": 45}),
}
# the default run's depth cuts of the disk and the eigenvalue record
BTLU_CUTS = {"unstructured_101k": {"lvpp": 1, "newton": [5]},
             "eigenvalue_100_streamed": {"lvpp": 0, "newton": 1}}

class FactorTap:
    """While open, records the (nb, bs, layout) of every block-tridiagonal
    factorization chosen (la/blocktri.factorization)."""

    def __enter__(self):
        from proximalgalerkin_torch.la import blocktri
        self.seen, self._real = set(), blocktri.factorization
        tap = self

        def factorization(blocking, dtype, *args, **kwargs):
            cls = tap._real(blocking, dtype, *args, **kwargs)
            tap.seen.add((blocking.nb, blocking.bs, dtype,
                          "streamed" if "Streamed" in cls.__name__
                          else "dense"))
            return cls

        blocktri.factorization = factorization
        return self

    def __exit__(self, *exc):
        from proximalgalerkin_torch.la import blocktri
        blocktri.factorization = self._real


def btlu_record(dev, name: str, cut: bool = False) -> dict:
    """BTLU_RECORDS[name] on dev, whole or at its BTLU_CUTS depth: prints
    its seconds, counts against the pinned ones, shares, refactors, peak
    device memory and blocking, and checks them; returns the readings."""
    title, run, pinned = BTLU_RECORDS[name]
    if cut:
        title, pinned = f"{title}, depth cut", BTLU_CUTS[name]
    with FactorTap() as tap:
        (counts, converged, extra), secs, timer, launches, peak = \
            timed_run(dev, lambda tm: run(dev, tm, cut))
    print(f"{name} ({title}): {secs:.2f} s, counts {counts}; pinned "
          f"{pinned}; converged {converged}; refactors "
          f"{timer.counts.get('bt_factor', 0)}; blocking (nb, bs, factor "
          f"dtype, layout) {sorted(tap.seen)}; peak device memory "
          f"{peak:.2f} GiB; launches {launches}", flush=True)
    print(f"  shares: {shares(timer, secs)}; PhaseTimer:\n    "
          + timer.report().replace("\n", "\n    "), flush=True)
    for what, ok in extra:
        print(f"  {what}: {ok}", flush=True)
        check(ok, f"{name}: {what}")
    check(counts == pinned, f"{name} counts {counts} equal {pinned}")
    # a depth cut ends before its LVPP loop converges
    check(converged or cut, f"{name} converged")
    check(len(tap.seen) > 0, f"{name} ran the btlu direction")
    check_launches(launches, name, uses=(
        ("bt_apply",) if any(s[-1] == "dense" for s in tap.seen) else ()))
    return {"name": name, "secs": secs, "counts": counts,
            "refactors": timer.counts.get("bt_factor", 0),
            "blocking": sorted(tap.seen), "peak_gib": peak}


def stamp(what: str):
    print(f"-- {what} done, {time.perf_counter() - T_START:.1f} s into "
          "the run", flush=True)


def main():
    if sys.argv[1:2] == ["--ab-child"]:
        return ab_child(*sys.argv[2:4])
    if sys.argv[1:2] == ["--ab"]:
        return ab(sys.argv[2])
    if sys.argv[1:2] == ["--sizes"]:
        bad = set(sys.argv[2:]) - set(SIZES)
        check(not bad, f"--sizes takes names of {SIZES}, not {bad}")
        with tracing():
            return sizes(sys.argv[2:] or SIZES)
    if sys.argv[1:2] == ["--cpu-cases"]:
        import pickle
        t0 = time.perf_counter()
        with open(sys.argv[3], "wb") as f:
            pickle.dump(cpu_cases(sys.argv[2]), f)
        print(f"{time.perf_counter() - t0:.1f}", flush=True)
        return
    if sys.argv[1:2] == ["--record"]:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        with tracing():
            if sys.argv[2] == "eikonal_ball":
                ball_record(dev)              # a failed check raises
                print(json.dumps({"key": "eikonal_ball"}), flush=True)
            elif sys.argv[2] == "btlu_cuts":
                print(json.dumps({"key": "btlu_cuts", "runs": [
                    btlu_record(dev, name, cut=True) for name in BTLU_CUTS]}),
                    flush=True)
            else:
                print(json.dumps(multiphase_record(sys.argv[2], dev)),
                      flush=True)
        return
    phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    timing = phase_kernel(dev)
    offsets, data = p1_operator(dev, 1024, 1024)
    t_spmv = phase_dia_spmv(dev, offsets, data)
    t_k1, t_k2 = phase_dia_cg(dev, offsets, data)
    del data
    u_mg, c_mg = phase_main_mg(dev)
    c_jac = phase_main_jacobi(dev, u_mg)
    stamp("phases 1-7")
    fd_res = phase_fd(dev)
    stamp("phase 8")
    # the PhaseTimer reports of phases 9-14 are synchronised: tracing on
    with tracing():
        lvpp_a = phase_lvpp(dev)
        stamp("phase 9")
        # 11 (iv) and 12 (ii)'s ball, host SuperLU for about 2 minutes each,
        # run in child processes beside the card-against-CPU checks, which
        # time nothing, and so do the CPU halves of those checks, one child a
        # phase; every other timed run starts after they have ended
        multiphase_24 = RecordProcess("multiphase_24")
        ball = RecordProcess("eikonal_ball")
        cuts = RecordProcess("btlu_cuts")
        cpu = {g: CpuCases(g) for g in ("10", "11", "12", "13", "14")}
        try:
            phase_model_cases(dev, cpu["10"])
            phase_btlu_cases(dev, cpu["11"])
            phase_schur_cases(dev, cpu["12"])
            phase_contact_cases(dev, cpu["13"])
            phase_dist_cases(dev, cpu["14"])
            stamp("phases 10 (i)-14 (i)")
            rec_24 = multiphase_24.result()
            rec_ball = ball.result()
            rec_cuts = cuts.result()
        finally:
            multiphase_24.stop()
            ball.stop()
            cuts.stop()
            for c in cpu.values():
                c.stop()
        stamp("the wait for phases 11 (iv), 11 (vi) and 12 (ii)'s ball")
        print("== phase 11 (vi): the btlu device records' depth cuts (a child "
              "process beside the (i) checks)\n" + rec_cuts["out"], flush=True)
        check([r["name"] for r in rec_cuts["runs"]] == list(BTLU_CUTS),
              "11 (vi) ran every depth cut")
        phase_model_records(dev)
        stamp("phase 10 (ii)")
        phase_btlu(dev, lvpp_a, rec_24)
        stamp("phase 11 (ii)-(v)")
        phase_schur(dev, rec_ball)
        stamp("phase 12 (ii)-(iv)")
        phase_contact(dev, fd_res)
        stamp("phase 13 (ii)-(iv)")
        t_ebe, t_bt = phase_distributed(dev)
        stamp("phase 14 (ii)-(iv)")
    print(f"smoke run {time.perf_counter() - T_START:.1f} s", flush=True)

    def entry(name, source, replaces, launches, timing, **extra):
        return dict(name=name, route="cuda",
                    source=f"proximalgalerkin_torch/csrc/{source}",
                    replaces=f"{replaces} (JAX reference package)",
                    launches=launches, **timing, **extra)

    ebe_launches = t_ebe.pop("launches")
    bt_launches = t_bt.pop("launches")

    print(json.dumps({"kernels": [
        entry("fused_mg_pcg", "mgfused.cu",
              "ops/mgfused.py:237 FusedMgCg._kernel",
              c_mg["fused_mg_pcg"], timing),
        entry("dia_spmv", "dia.cu", "ops/pallas_spmv.py:26 _dia_kernel",
              c_mg["dia_spmv"] + c_jac["dia_spmv"], t_spmv,
              launches_by_path={"mg": c_mg["dia_spmv"],
                                "jacobi": c_jac["dia_spmv"]}),
        entry("dia_cg_k1", "dia.cu", "ops/pallas_cg.py:118 k1_kernel",
              c_jac["dia_cg"], t_k1),
        entry("dia_cg_k2", "dia.cu", "ops/pallas_cg.py:151 k2_kernel",
              c_jac["dia_cg"], t_k2),
        entry("ebe_apply", "ebe.cu", "no TPU kernel: jax.jvp under jit in "
              "parallel/dofpart.py", ebe_launches, t_ebe,
              launches_where="224^2 distributed record, warm-ups and "
              "captures; its graphs replay each action"),
        entry("bt_apply", "btapply.cu", "no TPU kernel: two lax.scan loops "
              "in la/blocktri.py bt_apply", bt_launches, t_bt,
              launches_where="224^2 distributed record, warm-ups and "
              "captures; its graphs replay each Schwarz apply")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
