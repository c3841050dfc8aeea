"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. the card (nvidia-smi name and power limit, torch and CUDA versions);
2. build of the fused MG-PCG kernel (csrc/mgfused.cu) from the sources;
3. the kernel against its plain PyTorch version on the card, at m = 1025
   on a deep-contact Schur state made with numpy from a seed: matvec,
   restriction, prolongation, one V-cycle, a whole solve, chunk-size
   invariance (m = 257), a zero right-hand side, and their times;
4. the main path: the 1024^2 mixed-precision pc="mg" LVPP obstacle solve
   (2,101,250 dofs), checked for convergence, feasibility and kernel
   launches, plus a 32^2 solve on the card held against the same solve
   on the CPU;
5. a JSON line of the kernels, then the JSON status line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0


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
    from proximalgalerkin_torch.ops import mgfused
    t0 = time.time()
    report = mgfused.build(force=True)
    print(f"build {time.time() - t0:.2f} s", flush=True)
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas " + line.strip().split("ptxas info    : ")[-1],
                  flush=True)


def phase_kernel(dev) -> dict:
    print("== phase 3: kernel against plain version", flush=True)
    from proximalgalerkin_torch.ops import mg, mgfused
    m = 1025
    alpha, b, B, C, ws = grids_on(dev, m, SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)

    def rand(shape):
        return torch.randn(shape, generator=gen).to(dev)

    p = rand((m, m))
    err = rel_max(mgfused.kernel_matvec(p, B, C, alpha),
                  mgfused.matvec_reference(p, B, C, alpha))
    print(f"matvec      m={m} max rel diff {err:.3e} (bound 1e-6)")
    check(err <= 1e-6, "matvec")
    f = rand((m, m))
    err = rel_max(mgfused.kernel_restrict(f), mg.restrict(f))
    print(f"restrict    m={m} max rel diff {err:.3e} (bound 1e-6)")
    check(err <= 1e-6, "restrict")
    mc = (m - 1) // 2 + 1
    e, xf = rand((mc, mc)), rand((m, m))
    err = rel_max(mgfused.kernel_prolong_add(e, xf.clone()),
                  xf + mg.prolong(e))
    print(f"prolong+add m={m} max rel diff {err:.3e} (bound 1e-6)")
    check(err <= 1e-6, "prolong")
    err = rel_max(mgfused.kernel_pc(b, B, ws, alpha),
                  mgfused.pc_reference(b, B, ws, alpha))
    print(f"V-cycle pc  m={m} levels={len(ws)} max rel diff {err:.3e} "
          "(bound 1e-5)")
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
    print(f"time        m={m} kernel solve {ms_k:.3f} ms, plain solve "
          f"{ms_p:.3f} ms (median of 3, {itk} iterations)", flush=True)

    a2, b2, B2, C2, ws2 = grids_on(dev, 257, SEED + 3)
    x64, i64 = mgfused.solve(b2, B2, C2, ws2, a2, tol, maxiter, chunk=64)
    x5, i5 = mgfused.solve(b2, B2, C2, ws2, a2, tol, maxiter, chunk=5)
    print(f"chunk 64/5  m=257 its {i64}/{i5} bitwise equal "
          f"{bool(torch.equal(x64, x5))}")
    check(i64 == i5 and torch.equal(x64, x5), "chunk invariance")
    x0, i0 = mgfused.solve(torch.zeros_like(b), B, C, ws, alpha, tol,
                           maxiter)
    print(f"b = 0       m={m} its {i0} max|x| {float(x0.abs().max())}",
          flush=True)
    check(i0 == 0 and float(x0.abs().max()) == 0.0, "zero rhs")
    return {"max_abs_err": max_abs, "ms": ms_k, "plain_ms": ms_p}


def phase_main(dev) -> int:
    print("== phase 4: main path", flush=True)
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
    from proximalgalerkin_torch.ops import mgfused
    kw = dict(alpha_cap=1e2, outer_tol=1e-8, mixed_precision=True, pc="mg")

    # the repo's own check (the reference's fused-vs-plain trajectory
    # test): the kernel path on the card against the plain path on the
    # CPU, at 32^2
    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    r_c = P1ObstacleSolver(mesh, device=dev, **kw).solve(max_outer=6)
    r_h = P1ObstacleSolver(mesh, device="cpu", **kw).solve(max_outer=6)
    du = float(np.abs(r_c.u - r_h.u).max())
    print(f"32^2 card vs cpu: newton {r_c.newton_per_outer} vs "
          f"{r_h.newton_per_outer}, max|du| {du:.3e} (atol 5e-9)")
    check(r_c.newton_per_outer == r_h.newton_per_outer,
          "32^2 Newton trajectory")
    check(bool(np.allclose(r_c.u, r_h.u, atol=5e-9)), "32^2 u")

    t0 = time.time()
    mesh = rectangle_mesh(1024, 1024, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    solver = P1ObstacleSolver(mesh, device=dev, **kw)
    torch.cuda.synchronize()
    setup = time.time() - t0
    mgfused.solve.launches = 0
    t0 = time.time()
    res = solver.solve()
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = mgfused.solve.launches
    feas = float((res.u - solver.phi.cpu().numpy()).min())
    print(f"1024^2 dofs {2 * solver.N} setup {setup:.2f} s solve "
          f"{elapsed:.2f} s outer {res.outer_iterations} newton "
          f"{res.newton_its} cg {res.cg_its_total} feasibility {feas:.3e} "
          f"launches {launches}")
    print(f"newton_per_outer {res.newton_per_outer}", flush=True)
    check(res.converged, "1024^2 converged")
    check(res.u.shape == (solver.N,) and bool(np.isfinite(res.u).all()),
          "u finite, of shape (N,)")
    check(feas >= -1e-10, "feasibility")
    check(launches > 0, "kernel launched on the main path")
    return launches


def main():
    phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    timing = phase_kernel(dev)
    launches = phase_main(dev)
    print(json.dumps({"kernels": [dict(
        name="fused_mg_pcg", route="cuda",
        source="proximalgalerkin_torch/csrc/mgfused.cu",
        replaces="ops/mgfused.py:237 FusedMgCg._kernel (JAX reference package)",
        launches=launches, **timing)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
