"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py              # the smoke run
    python3 chip_smoke.py --ab PARENT  # A/B of the 1024^2 solves only

Phases, each printing its own lines; any failure exits non-zero:

1. the card (nvidia-smi name and power limit, torch and CUDA versions);
2. build of the CUDA kernels (csrc/mgfused.cu and csrc/dia.cu) from the
   sources, one nvcc for each, started together;
3. the fused MG-PCG kernel against its plain PyTorch version on the card,
   at m = 1025 on a deep-contact Schur state made with numpy from a seed:
   its pieces (matvec step, down and up legs of a level, one V-cycle), a
   whole solve with its time per iteration beside its bound and its
   device time by kernel and idle share (torch.profiler), chunk-size
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
   solve (2,101,250 dofs), checked for convergence, feasibility and
   kernel launches, with its time per CG iteration and the device's idle
   share over outer step 1;
7. the main path with pc="jacobi": the same two solves with the same
   readings, the 1024^2 solution held against the mg one, and
   solve_fused() at 32^2;
8. a JSON line of the kernels, then the JSON status line.

The kernel launch counters are set to 0 just before each 1024^2 solve and
read just after it.

With --ab PARENT (PARENT: an unpacked copy of another commit of the
repository), the 1024^2 mixed + mg solve of PARENT's package and of this
one run in turns (parent, this, this, parent), each in its own process,
then the mixed + jacobi solve likewise; each line gives the solve's
seconds, its time per CG iteration, its counts and a hash of u, and the
jacobi solutions are held against the mg one.
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

SEED = 0
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


def device_ms(fn, names, calls: int = 50) -> dict:
    """Device time per launch in ms of each kernel whose name holds one of
    `names`, from torch.profiler over `calls` calls of fn (after a
    warm-up call). Fails if the profiler saw no launch of one of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name in names:
        hits = [e for e in events if name in e.key and e.device_time_total > 0]
        count = sum(e.count for e in hits)
        check(count > 0, f"the profiler saw {name} on the device")
        out[name] = sum(e.device_time_total for e in hits) / count / 1e3
    return out


def busy_profile(fn):
    """Runs fn() once under torch.profiler. Returns (fn's result, wall ms,
    device busy ms, {kernel: (device ms, launches)}). Busy time is the
    union of the device intervals the profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
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
    from proximalgalerkin_torch.ops import dia_spmv, mgfused

    def one(mod):
        t0 = time.time()
        report = mod.build(force=True)
        return time.time() - t0, report

    with ThreadPoolExecutor(2) as ex:
        futs = {name: ex.submit(one, mod)
                for name, mod in (("mgfused", mgfused), ("dia", dia_spmv))}
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
    ms, lt = mgfused.level_plan(m)
    err = rel_max(mgfused.kernel_pc(b, B, ws, alpha),
                  mgfused.pc_reference(b, B, ws, alpha))
    print(f"V-cycle pc  m={m} levels {ms}, tail from level {lt} max rel "
          f"diff {err:.3e} (bound 1e-5)")
    check(err <= 1e-5, "V-cycle")

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
    from proximalgalerkin_torch.ops import dia_cg, dia_spmv, mgfused
    mgfused.solve.launches = 0
    dia_spmv.dia_spmv.launches = 0
    dia_cg.solve.launches = 0
    dia_cg.solve.replays = 0


def read_counters() -> dict:
    from proximalgalerkin_torch.ops import dia_cg, dia_spmv, mgfused
    return {"fused_mg_pcg": mgfused.solve.launches,
            "dia_spmv": dia_spmv.dia_spmv.launches,
            "dia_cg": dia_cg.solve.launches,
            "dia_cg_replays": dia_cg.solve.replays}


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


def drive_main(dev, pc: str, n: int = 1024, inner=None):
    """The 32^2 card-vs-CPU check, then the n^2 solve with pc; returns
    (the solver, its result, the launch counts of the n^2 solve). inner:
    a context entered around the n^2 solve alone."""
    import contextlib
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
    reset_counters()
    t0 = time.time()
    with inner or contextlib.nullcontext():
        res = solver.solve()
        torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = read_counters()
    feas = float((res.u - solver.phi.cpu().numpy()).min())
    print(f"{n}^2 pc={pc} dofs {2 * solver.N} setup {setup:.2f} s solve "
          f"{elapsed:.2f} s outer {res.outer_iterations} newton "
          f"{res.newton_its} cg {res.cg_its_total} feasibility {feas:.3e} "
          f"launches {counts}")
    print(f"newton_per_outer {res.newton_per_outer}; SHA-256 of u "
          f"{hashlib.sha256(res.u.tobytes()).hexdigest()[:16]}", flush=True)
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


def ab_child(pc: str, out: str):
    """One 1024^2 mixed solve with `pc` of the package in the working
    directory (after a warm-up solve); saves u to `out` and prints one
    JSON line."""
    import os
    sys.path.insert(0, os.getcwd())
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
    print(json.dumps({
        "package": mgfused.__file__, "pc": pc, "solve_s": elapsed,
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


def main():
    if sys.argv[1:2] == ["--ab-child"]:
        return ab_child(*sys.argv[2:4])
    if sys.argv[1:2] == ["--ab"]:
        return ab(sys.argv[2])
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

    def entry(name, source, replaces, launches, timing, **extra):
        return dict(name=name, route="cuda",
                    source=f"proximalgalerkin_torch/csrc/{source}",
                    replaces=f"{replaces} (JAX reference package)",
                    launches=launches, **timing, **extra)

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
              c_jac["dia_cg"], t_k2)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
