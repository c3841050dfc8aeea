"""Tests of the port's CUDA kernels; they need a card and skip without
one. This file imports no jax, so on a machine with a card and without
jax it runs alone, without the suite's conftest (tests/test_torch_multihost.py
holds the distributed layer's multi-process runs on the CPU):

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
from proximalgalerkin_torch.ops import dia_cg, mgfused
from proximalgalerkin_torch.ops.dia_spmv import dia_spmv, dia_spmv_reference

from chip_smoke import (BTLU_CASES, CONTACT_CASES, DIST_CASES,
                        FRACTURE_DIST_OPTS, MODELS, MULTIPHASE_CASES,
                        SCHUR_CASES, btlu_case, contact_case, dia_cg_system,
                        dist_case, field_rtol, grids_on, model_case,
                        multiphase_case, p1_operator, rel_field,
                        residual_ratio, schur_case)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA only")
    return torch.device("cuda")


def _rel(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


# Every split of the V-cycle (mgfused.level_plan): all levels in the
# one-block tail (12, 17, 33, 35, 65), a grid level above a one-block
# tail (67: levels 67, 34), one level too large for the tail and swept by
# grid kernels (100), a grid level above a coarsest level swept by grid
# kernels (131: levels 131, 66), all levels in the cluster tail (129,
# 257), grid levels above it (513, 1025)
@pytest.mark.parametrize("m", [12, 17, 33, 35, 65, 67, 100, 129, 131, 257,
                               513, 1025])
def test_kernel_matches_plain(cuda, m):
    alpha, b, B, C, whier = grids_on(cuda, m, 0)
    assert _rel(mgfused.kernel_matvec(b, B, C, alpha),
                mgfused.matvec_reference(b, B, C, alpha)) <= 1e-6
    t0 = b / b.abs().max()
    for u, v in zip(mgfused.kernel_matvec_update(t0, b, B, C, whier[0],
                                                 alpha, 0.375),
                    mgfused.matvec_update_reference(t0, b, B, C, whier[0],
                                                    alpha, 0.375)):
        assert _rel(u, v) <= 1e-6
    if len(whier) > 1:
        assert _rel(mgfused.kernel_down(b, whier[0], alpha),
                    mgfused.down_reference(b, whier[0], alpha)) <= 1e-5
        e = whier[1] / whier[1].abs().max()
        assert _rel(mgfused.kernel_up(b, whier[0], e, alpha),
                    mgfused.up_reference(b, whier[0], e, alpha)) <= 1e-5
    assert _rel(mgfused.kernel_pc(b, B, whier, alpha),
                mgfused.pc_reference(b, B, whier, alpha)) <= 1e-5
    before = mgfused.solve.launches
    xk, ik = mgfused.solve(b, B, C, whier, alpha, 1e-6, 500)
    assert mgfused.solve.launches > before
    xp, ip = mgfused.fused_mg_pcg_reference(b, B, C, whier, alpha, 1e-6,
                                            500)
    assert ik > 0 and abs(ik - ip) <= 3
    assert float(torch.linalg.norm(xk - xp)) <= 1e-4 * float(
        torch.linalg.norm(xp))
    for chunk in (5, 1):
        xc, ic = mgfused.solve(b, B, C, whier, alpha, 1e-6, 500,
                               chunk=chunk)
        assert ic == ik and torch.equal(xc, xk)
    x0, i0 = mgfused.solve(torch.zeros_like(b), B, C, whier, alpha, 1e-6,
                           500)
    assert i0 == 0 and float(x0.abs().max()) == 0.0
    _, i7 = mgfused.solve(b, B, C, whier, alpha, 1e-30, 7, chunk=3)
    assert i7 == 7


@pytest.mark.parametrize("m", [129, 1025])
def test_kernel_pc_is_the_plan_bit_for_bit(cuda, m):
    """The kernel's preconditioner, the cluster tail at its bottom, gives
    the bits of its plain version split as planned: every pass of the
    tail is pointwise, in the plain version's order."""
    alpha, b, B, C, whier = grids_on(cuda, m, 0)
    assert mgfused.level_plan(m)[2] > 1
    assert torch.equal(mgfused.kernel_pc(b, B, whier, alpha),
                       mgfused.pc_by_plan_reference(b, B, whier, alpha))


def test_level_plan_is_the_kernels_split(cuda):
    """level_plan's copy of the tail's shape arithmetic (tail_bytes,
    cluster_levels) decides as the kernel library does: at every m up to
    4099 the library takes the planned split, and from every level of at
    most 257 it takes a tail on a cluster of 8 or 16 blocks exactly where
    the copy finds one that fits."""
    lib = mgfused._lib()
    for m in range(3, 4100):
        ms, lt, nb = mgfused.level_plan(m)
        assert lib.mgf_ws_floats(m, lt, nb) >= 0, m
        for l, top in enumerate(ms):
            if top > 257:
                continue
            tail = ms[l:]
            for nb in (8, 16):
                fits = (0 < mgfused.cluster_levels(tail, nb) < len(tail)
                        and mgfused.tail_bytes(tail, nb) <= mgfused.MAX_SMEM)
                assert (lib.mgf_ws_floats(m, l, nb) >= 0) == fits, (m, l, nb)


def test_cluster_tail_counter_counts_its_iterations(cuda):
    """Under tracing, a solve with the cluster tail (m = 1025) adds its CG
    iterations to mgpcg.cluster_tail_its, one with the one-block tail
    (m = 65) adds none."""
    from proximalgalerkin_torch.core.logging import counter, tracing
    for m, cluster in ((1025, True), (65, False)):
        alpha, b, B, C, whier = grids_on(cuda, m, 0)
        with tracing():
            before = counter("mgpcg.cluster_tail_its")
            _, its = mgfused.solve(b, B, C, whier, alpha, 1e-6, 500)
            added = counter("mgpcg.cluster_tail_its") - before
        assert its > 0 and added == (its if cluster else 0)


@pytest.mark.parametrize("m", [33, 257])
def test_kernel_reuses_workspace_and_graphs(cuda, m):
    """Two solves in a row with other alpha and b give the bits of fresh
    solves (new workspace, new graphs)."""
    a1, b1, B, C, whier = grids_on(cuda, m, 0)
    a2, b2 = 2.5 * a1, b1.flip(0).contiguous()
    tol = 1e-6
    x1, i1 = mgfused.solve(b1, B, C, whier, a1, tol, 500)
    x2, i2 = mgfused.solve(b2, B, C, whier, a2, tol, 500)
    for x, i, a, bb in ((x2, i2, a2, b2), (x1, i1, a1, b1)):
        mgfused.release_workspaces()
        xf, itf = mgfused.solve(bb, B, C, whier, a, tol, 500)
        assert itf == i and torch.equal(xf, x)


def test_kernel_underflowing_quotients_give_plain_bits(cuda):
    """Pinned points (huge diagonal) with a tiny right-hand side, far
    apart on a zero grid: the pre-smooth and post-smooth quotients at
    them and at their neighbours underflow into the subnormals, where
    the kernel divides through f64. The up leg (with e = 0, every stencil
    sum exact) must give the bits of the plain version."""
    m, alpha = 33, 37.0
    b = torch.zeros((m, m), dtype=torch.float32)
    w = torch.ones((m, m), dtype=torch.float32)
    for (i, j), bv, wv in (((8, 8), 1e-10, 1e30), ((8, 24), -3e-12, 3e31),
                           ((24, 8), 7e-9, 1e28), ((24, 24), 2e-20, 1e10),
                           ((16, 16), 1e-30, 1.0)):
        b[i, j], w[i, j] = bv, wv
    b, w = b.to(cuda), w.to(cuda)
    e = torch.zeros(((m + 1) // 2,) * 2, dtype=torch.float32, device=cuda)
    tk = mgfused.kernel_up(b, w, e, alpha)
    tp = mgfused.up_reference(b, w, e, alpha)
    tiny = torch.finfo(torch.float32).tiny
    assert int(((tp != 0) & (tp.abs() < tiny)).sum()) >= 10
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))


def test_kernel_rejects_bad_inputs(cuda):
    alpha, b, B, C, whier = grids_on(cuda, 33, 0)
    with pytest.raises(TypeError):
        mgfused.solve(b, B.double(), C, whier, alpha, 1e-6, 10)
    with pytest.raises(ValueError):
        mgfused.solve(b, B, C.cpu(), whier, alpha, 1e-6, 10)
    with pytest.raises(ValueError):
        mgfused.kernel_up(b[:-1].contiguous(), b[:-1].contiguous(),
                          whier[1], alpha)
    with pytest.raises(ValueError):
        mgfused.kernel_down(b[:-1, :-1].contiguous(),
                            b[:-1, :-1].contiguous(), alpha)


def test_solver_on_card_matches_cpu(cuda):
    """Mixed + mg at 32^2: the kernel on the card and the plain version
    on the CPU take the same Newton trajectory (the reference's own
    fused-vs-plain bound, atol 5e-9)."""
    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    kw = dict(alpha_cap=1e2, outer_tol=1e-8, mixed_precision=True, pc="mg")
    before = mgfused.solve.launches
    r_c = P1ObstacleSolver(mesh, device=cuda, **kw).solve(max_outer=6)
    assert mgfused.solve.launches > before
    r_h = P1ObstacleSolver(mesh, device="cpu", **kw).solve(max_outer=6)
    assert r_c.newton_per_outer == r_h.newton_per_outer
    assert np.allclose(r_c.u, r_h.u, atol=5e-9)


@pytest.mark.parametrize("m", [12, 33, 257])
def test_dia_spmv_matches_plain(cuda, m):
    """Same sums in the same order: bitwise expected; bounds 1e-15 (f64)
    and 1e-6 (f32) relative."""
    offsets, data = p1_operator(cuda, m - 1, m - 1)
    x = torch.as_tensor(np.random.default_rng(m).normal(size=m * m),
                        device=cuda)
    for dt, bound in ((torch.float64, 1e-15), (torch.float32, 1e-6)):
        d, xd = data.to(dt), x.to(dt)
        before = dia_spmv.launches
        y = dia_spmv(offsets, d, xd)
        assert dia_spmv.launches == before + 1
        assert _rel(y, dia_spmv_reference(offsets, d, xd)) <= bound


# n = m^2 is never a multiple of the 256-row run or of K1's 1,024-row
# band: 12 and 33 end inside the first or second band, 257 and 1025 have
# a ragged last run; at 12 and 33 the whole stencil is one staged
# segment, at 257 and 1025 three
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [12, 33, 257, 1025])
def test_dia_cg_kernels_match_plain(cuda, m, dtype):
    """K1, K2 and whole solves give the plain version's bits, for every
    chunk size."""
    offsets, data = p1_operator(cuda, m - 1, m - 1)
    eff, b = dia_cg_system(cuda, offsets, data, m, 0)
    eff, b = eff.to(dtype), b.to(dtype)
    rng = np.random.default_rng(m)
    p = torch.as_tensor(rng.normal(size=m * m), dtype=dtype, device=cuda)
    beta = torch.tensor(0.375, dtype=dtype, device=cuda)
    a = torch.tensor(0.25, dtype=dtype, device=cuda)
    for u, v in zip(dia_cg.kernel_k1(offsets, eff, b, p, 0.375),
                    dia_cg.k1_reference(offsets, eff, b, p, beta)):
        assert torch.equal(u, v)
    for u, v in zip(dia_cg.kernel_k2(offsets, p, b, b, p, 0.25),
                    dia_cg.k2_reference(p, b, b, p, a)):
        assert torch.equal(u, v)
    # K1 and K2 ran on the one workspace the solves will use
    assert sum(key[1:] == (m * m, tuple(offsets), dtype)
               for key in dia_cg._workspaces) == 1
    tol = 1e-5
    launches, replays = dia_cg.solve.launches, dia_cg.solve.replays
    xk, ik = dia_cg.solve(offsets, eff, b, tol, 2000)
    assert dia_cg.solve.replays - replays == -(-max(ik, 1) // 64)
    assert dia_cg.solve.launches - launches == 64 * -(-max(ik, 1) // 64)
    xp, ip = dia_cg.fused_dia_cg_reference(offsets, eff, b, tol, 2000)
    assert ik == ip > 0 and torch.equal(xk, xp)
    assert residual_ratio(offsets, eff, b, xk) <= 1.5 * tol
    for chunk in (5, 1):
        xc, ic = dia_cg.solve(offsets, eff, b, tol, 2000, chunk=chunk)
        assert ic == ik and torch.equal(xc, xk)
    x0, i0 = dia_cg.solve(offsets, eff, torch.zeros_like(b), tol, 2000)
    assert i0 == 0 and float(x0.abs().max()) == 0.0
    _, i7 = dia_cg.solve(offsets, eff, b, 1e-30, 7, stall_guard=0.0,
                         chunk=3)
    assert i7 == 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [33, 257])
def test_dia_cg_reuses_workspace_and_graphs(cuda, m, dtype):
    """Two solves in a row with other matrices and right-hand sides give
    the bits of fresh solves (new workspace, new graphs)."""
    offsets, data = p1_operator(cuda, m - 1, m - 1)
    systems = [tuple(t.to(dtype) for t in dia_cg_system(
        cuda, offsets, data, m, seed, m2d_scale=scale))
        for seed, scale in ((0, 1.0), (5, 0.5))]
    first = [dia_cg.solve(offsets, eff, b, 1e-5, 2000)
             for eff, b in systems]
    assert len(dia_cg._workspaces) >= 1
    for (eff, b), (x, its) in reversed(list(zip(systems, first))):
        dia_cg.release_workspaces()
        assert dia_cg._workspaces == {}
        xf, itf = dia_cg.solve(offsets, eff, b, 1e-5, 2000)
        assert itf == its > 0 and torch.equal(xf, x)


def test_dia_cg_workspaces_of_other_plans_share_k1(cuda):
    """A workspace made later with a smaller shared-memory plan (33^2: one
    staged segment) leaves an earlier one with a larger plan (257^2:
    three) able to capture and launch: K1's shared-memory limit belongs
    to the kernel, not to a workspace."""
    dia_cg.release_workspaces()
    solved = []
    for m in (257, 33):
        offsets, data = p1_operator(cuda, m - 1, m - 1)
        eff, b = dia_cg_system(cuda, offsets, data, m, 0)
        x, its = dia_cg.solve(offsets, eff, b, 1e-5, 2000)
        smem = dia_cg._workspace(tuple(offsets), b).k1_shape()[1]
        solved.append((offsets, eff, b, x, its, smem))
    assert solved[1][5] < solved[0][5] and solved[1][4] > 0
    # a graph not yet captured on the first workspace
    offsets, eff, b, x, its, _ = solved[0]
    x5, i5 = dia_cg.solve(offsets, eff, b, 1e-5, 2000, chunk=5)
    assert i5 == its > 0 and torch.equal(x5, x)


# offsets with no two within a cluster's reach (every diagonal read
# through the cache), a cluster beside lone diagonals, and 64 diagonals
# (bands of one run); n chosen ragged
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, offsets", [
    (5000, (-1300, -450, 0, 77, 900)),
    (2500, (-700, -2, 0, 3, 1200)),
    (3001, tuple(range(-300, 340, 10))),
])
def test_dia_cg_any_offsets(cuda, n, offsets, dtype):
    """K1 and a whole solve on a diagonally dominant random operator with
    the given offsets: the plain version's bits."""
    rng = np.random.default_rng(n)
    d = rng.uniform(-1.0, 1.0, size=(len(offsets), n)) / len(offsets)
    d[offsets.index(0)] = 2.0 + rng.random(n)
    data = torch.as_tensor(d, dtype=dtype, device=cuda)
    b = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=cuda)
    p = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=cuda)
    beta = torch.tensor(0.375, dtype=dtype, device=cuda)
    for u, v in zip(dia_cg.kernel_k1(offsets, data, b, p, 0.375),
                    dia_cg.k1_reference(offsets, data, b, p, beta)):
        assert torch.equal(u, v)
    xk, ik = dia_cg.solve(offsets, data, b, 1e-5, 300)
    xp, ip = dia_cg.fused_dia_cg_reference(offsets, data, b, 1e-5, 300)
    assert ik == ip > 0 and torch.equal(xk, xp)
    x1, i1 = dia_cg.solve(offsets, data, b, 1e-5, 300, chunk=7)
    assert i1 == ik and torch.equal(x1, xk)


def test_dia_kernels_reject_bad_inputs(cuda):
    offsets, data = p1_operator(cuda, 32, 32)
    eff, b = dia_cg_system(cuda, offsets, data, 33, 0)
    with pytest.raises(TypeError):
        dia_cg.solve(offsets, eff.double(), b, 1e-6, 10)
    with pytest.raises(ValueError):
        dia_cg.solve(offsets, eff.cpu(), b, 1e-6, 10)
    with pytest.raises(ValueError):
        dia_spmv(offsets, data[:, :-1].contiguous(), b.double())


def test_mixed_jacobi_on_card_matches_cpu(cuda):
    """Mixed + jacobi at 32^2: the DIA kernels on the card and their
    plain versions on the CPU take the same Newton trajectory (atol
    5e-9); solve_fused on the card gives bitwise the u of solve()."""
    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    kw = dict(alpha_cap=1e2, outer_tol=1e-8, mixed_precision=True,
              pc="jacobi")
    before = dia_cg.solve.launches
    s = P1ObstacleSolver(mesh, device=cuda, **kw)
    r_c = s.solve(max_outer=6)
    assert dia_cg.solve.launches > before
    r_h = P1ObstacleSolver(mesh, device="cpu", **kw).solve(max_outer=6)
    assert r_c.newton_per_outer == r_h.newton_per_outer
    assert np.allclose(r_c.u, r_h.u, atol=5e-9)
    a, f = s.solve(), s.solve_fused()
    assert f.newton_its == a.newton_its
    assert np.abs(a.u - f.u).max() == 0.0


def test_lvpp_obstacle_on_card_matches_cpu(cuda):
    """The general LVPP stack (models/obstacle.py, default preonly/lu) at
    16^2 P1 on the card against the same run on the CPU: counts equal, u
    within 1e-10."""
    from proximalgalerkin_torch.models.obstacle import solve_obstacle_problem
    kw = dict(polynomial_order=1, alpha_scheme="double_exponential",
              alpha_max=1e2, tol_exit=1e-6, verbose=False)
    mesh = rectangle_mesh(16, 16, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    pc, rc = solve_obstacle_problem(mesh, device=cuda, **kw)
    ph, rh = solve_obstacle_problem(mesh, device="cpu", **kw)
    assert rc.converged and rc.newton_steps == rh.newton_steps
    assert rc.iterations == rh.iterations
    assert np.abs(pc.u(rc) - ph.u(rh)).max() <= 1e-10


@pytest.mark.parametrize("name", MODELS)
def test_model_on_card_matches_cpu(cuda, name):
    """Each LVPP example model at the smallest case of its CPU parity test
    (chip_smoke.model_case) on the card and on the CPU: counts equal,
    every field within 1e-10 relative (thermoforming 1e-7: its Newton
    tolerance fixes its iterate only to about 1e-9; chip_smoke.FIELD_RTOL)."""
    c_card, f_card = model_case(name, cuda)
    c_cpu, f_cpu = model_case(name, torch.device("cpu"))
    assert c_card == c_cpu
    for k in f_card:
        assert rel_field(f_card[k], f_cpu[k]) <= field_rtol(name), k


@pytest.mark.parametrize("name", list(BTLU_CASES))
def test_btlu_on_card_matches_cpu(cuda, name):
    """The gradient-constraint 12^2 P2 LVPP with each btlu option set of
    tests/test_torch_blocktri.py (Thomas f32, cyclic reduction, streamed,
    lagged f64 factor / f32 apply) on the card and on the CPU: counts
    equal, x within 1e-10 relative."""
    c_card, f_card = btlu_case(name, cuda)
    c_cpu, f_cpu = btlu_case(name, torch.device("cpu"))
    assert c_card == c_cpu and c_card["converged"]
    assert rel_field(f_card["x"], f_cpu["x"]) <= 1e-10


@pytest.mark.parametrize("name", list(MULTIPHASE_CASES))
def test_multiphase_on_card_matches_cpu(cuda, name):
    """Multiphase at N = 10, two steps, with the default LU and with the
    fused lagged btlu, on the card and on the CPU: per-step counts equal,
    u within 1e-10 relative."""
    c_card, f_card = multiphase_case(name, cuda)
    c_cpu, f_cpu = multiphase_case(name, torch.device("cpu"))
    assert c_card == c_cpu
    assert rel_field(f_card["u"], f_cpu["u"]) <= 1e-10


@pytest.mark.parametrize("name", list(SCHUR_CASES))
def test_schur_on_card_matches_cpu(cuda, name):
    """Phase 12 (i)'s cases on the card and on the CPU: a lattice
    V-cycle, the eikonal 12x3 with LU and Schur-MINRES and the star, the
    first LVPP step of gradient constraint 8^2 P2 with the fused Newton
    and schur and its first direction with schur_mg in double and mixed
    precision, Monge–Ampère k = 3, 4: counts equal, fields within
    SCHUR_CASES[name] relative."""
    c_card, f_card = schur_case(name, cuda)
    c_cpu, f_cpu = schur_case(name, torch.device("cpu"))
    assert c_card == c_cpu
    for k in f_card:
        assert rel_field(f_card[k], f_cpu[k]) <= SCHUR_CASES[name], k


@pytest.mark.parametrize("name", CONTACT_CASES)
def test_contact_on_card_matches_cpu(cuda, name):
    """Phase 13 (i)'s cases on the card and on the CPU: Signorini on the
    half-disk at res 0.06 and the half-sphere at res 0.16, compare_all on
    the 12^2 rectangle: counts equal, fields (u, psi, penetrations, von
    Mises; the solvers' solutions) within 1e-10 relative."""
    c_card, f_card = contact_case(name, cuda)
    c_cpu, f_cpu = contact_case(name, torch.device("cpu"))
    assert c_card == c_cpu
    for k in f_card:
        assert rel_field(f_card[k], f_cpu[k]) <= 1e-10, k


def test_signorini_trace_on_card(cuda, tmp_path):
    """One Signorini Newton step inside utils.profiling.device_trace on
    the card: the trace holds the span's range and CUDA kernels."""
    import json
    from proximalgalerkin_torch.core.logging import span
    from proximalgalerkin_torch.models.signorini import solve_signorini
    from proximalgalerkin_torch.utils.profiling import device_trace
    with device_trace(str(tmp_path)):
        with span("signorini_newton_step"):
            solve_signorini(res=0.06, verbose=False, max_iterations=1,
                            newton_max_its=1, device=cuda)
    (f,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(f.read_text())["traceEvents"]
    assert any(e.get("name") == "pg.signorini_newton_step" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)


def test_fd_obstacle_on_card_matches_cpu(cuda):
    from proximalgalerkin_torch.models.obstacle_fd import fd_obstacle_solve
    rc = fd_obstacle_solve(33, device=cuda)
    rh = fd_obstacle_solve(33, device="cpu")
    assert rc.newton_per_outer == rh.newton_per_outer
    assert np.abs(rc.u - rh.u).max() <= 1e-10


def test_device_loops_read_the_host_once_per_chunk(cuda):
    """On the card the Krylov loop reads the host once per 64-iteration
    chunk, the f64 refinement once per pass, the fused Newton loop once
    per Newton step (the host_reads counter of la/loop.while_loop)."""
    import math
    from proximalgalerkin_torch.la import krylov
    from proximalgalerkin_torch.core.logging import counter
    from proximalgalerkin_torch.models.obstacle import (coefficients_on,
                                                        setup_obstacle_problem)
    from proximalgalerkin_torch.solve.nonlinear import _refined
    rng = np.random.default_rng(0)
    Q = np.linalg.qr(rng.standard_normal((300, 300)))[0]
    A = torch.tensor(Q @ np.diag(np.linspace(1, 400, 300)) @ Q.T,
                     device=cuda)
    b = torch.tensor(rng.standard_normal(300), device=cuda)
    before = counter("host_reads")
    x, _, its = krylov.minres_info(lambda v: A @ v, b, tol=1e-12,
                                   maxiter=2000)
    reads = counter("host_reads") - before
    assert int(its) > 64 and reads == math.ceil(int(its) / 64)
    x1, _, its1 = krylov.minres_info(lambda v: A @ v, b, tol=1e-12,
                                     maxiter=2000, chunk=1)
    assert int(its1) == int(its) and float((x1 - x).abs().max()) <= 1e-12

    solves = []

    def solve_lo(r):
        solves.append(1)
        return krylov.cg(lambda v: A.float() @ v, r.float(), tol=1e-5,
                         maxiter=2000).double()

    before = counter("host_reads")
    dx = _refined(solve_lo, lambda v: A @ v, b, 1e-12, 0.0, 30)
    reads = counter("host_reads") - before
    assert float(torch.linalg.norm(A @ dx - b) / torch.linalg.norm(b)) \
        <= 1e-10
    # the passes' own reads, plus one cg chunk or more in each of the
    # len(solves) inner solves
    assert len(solves) + 1 <= reads - len(solves) <= len(solves) + 1 + \
        len(solves) * 2000 // 64

    mesh = rectangle_mesh(8, 8, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    prob = setup_obstacle_problem(mesh, verbose=False, device=cuda)
    nv = prob.V.num_dofs
    p = prob.problem
    p.update(coeffs=coefficients_on({"psi_k": np.zeros(nv),
                                     "u_k": np.zeros(nv)}, cuda))
    fused = p.fused_newton("cg", "jacobi", "ell", max_it=30)
    counted = []
    real = krylov.cg

    def cg(*a, **k):
        r0 = counter("host_reads")
        out = real(*a, **k)
        counted.append(counter("host_reads") - r0)
        return out

    krylov.cg = cg
    try:
        before = counter("host_reads")
        x, it, fn, f0, ok, sconv = fused(p.set_bc(prob.space.zeros()),
                                         rtol=1e-8, ksp_rtol=1e-12)
        reads = counter("host_reads") - before
    finally:
        krylov.cg = real
    assert bool(ok) and int(it) == len(counted) > 1
    assert reads == sum(counted) + int(it) + 1


@pytest.mark.parametrize("name", list(DIST_CASES))
def test_distributed_on_card_matches_cpu(cuda, name):
    """Phase 14 (i)'s cases on the card and on the CPU, 8 subdomains:
    dofpart's residual and Jacobian action (disk res 0.2 P1, 13x11 P2),
    the 3-step distributed LVPP on the disk res 0.25, the halo-exchange
    FD obstacle at N = 33: counts equal, fields within 1e-10 relative."""
    c_card, f_card = dist_case(name, cuda)
    c_cpu, f_cpu = dist_case(name, torch.device("cpu"))
    assert c_card == c_cpu
    for k in f_card:
        assert rel_field(f_card[k], f_cpu[k]) <= DIST_CASES[name], k


def test_distributed_fracture_on_card_matches_cpu(cuda):
    """The distributed fracture continuation on 8 subdomains (res 0.4,
    one load step, MINRES on the matrix-free action; its Jacobian actions
    replayed as CUDA graphs on the card): per-step counts equal to the
    CPU's, u and c within 1e-10."""
    from proximalgalerkin_torch.models.fracture import solve_fracture
    kw = dict(max_res=0.4, Tmax=0.3, num_load_steps=2, n_devices=8,
              solver_options=FRACTURE_DIST_OPTS, verbose=False)
    rc = solve_fracture(device=cuda, **kw)
    rh = solve_fracture(device="cpu", **kw)
    assert (rc.newton_per_step, rc.lvpp_per_step, rc.retries_per_step) == \
        (rh.newton_per_step, rh.lvpp_per_step, rh.retries_per_step)
    assert np.abs(rc.u - rh.u).max() <= 1e-10
    assert np.abs(rc.c - rh.c).max() <= 1e-10


def test_distributed_graph_replay_is_the_eager_action(cuda):
    """A Jacobian action replayed as a CUDA graph gives the eager action's
    values on the card."""
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from chip_smoke import _dist_obstacle
    prob, dp = _dist_obstacle(cuda, create_disk_mesh(0.2))
    N = prob.space.num_dofs
    rng = np.random.default_rng(0)
    x, v = dp.scatter(rng.standard_normal(N)), dp.scatter(
        rng.standard_normal(N))
    cv = dp._prep_coeffs({"phi": dp.scatter_cellq(
        prob.problem.coeffs["phi"])} | {
        k: dp.scatter_coeff(k, rng.standard_normal(
            prob.space.spaces["u"].num_dofs)) for k in ("psi_k", "u_k")})
    consts = {"alpha": torch.tensor(3.0, dtype=torch.float64, device=cuda)}
    graphed = dp._jac_operator(x, cv, {}, consts, dp.bc_mask)
    assert hasattr(graphed, "graph")
    eager = dp._jac_action(x, cv, {}, consts, dp.bc_mask)
    assert _rel(graphed(v), eager(v)) <= 1e-14
    assert _rel(graphed(2.0 * v), eager(2.0 * v)) <= 1e-14


def test_distributed_schwarz_graph_replay_is_the_eager_jvp_action(cuda):
    """On the asm_btlu path the Newton step's action, replayed as a CUDA
    graph from the Schwarz factor's element matrices through the
    element-by-element kernel, gives the eager jvp action's values within
    1e-13 relative (the kernel's atomics add in no fixed order)."""
    from proximalgalerkin_torch.core.logging import counter
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_torch.ops.ebe import ebe_apply
    from chip_smoke import _dist_obstacle
    prob, dp = _dist_obstacle(cuda, create_disk_mesh(0.2))
    N = prob.space.num_dofs
    rng = np.random.default_rng(0)
    x, v = dp.scatter(rng.standard_normal(N)), dp.scatter(
        rng.standard_normal(N))
    cv = dp._prep_coeffs({"phi": dp.scatter_cellq(
        prob.problem.coeffs["phi"])} | {
        k: dp.scatter_coeff(k, rng.standard_normal(
            prob.space.spaces["u"].num_dofs)) for k in ("psi_k", "u_k")})
    consts = {"alpha": torch.tensor(3.0, dtype=torch.float64, device=cuda)}
    captures, launches = counter("dist.graph_captures"), ebe_apply.launches
    Av, _ = dp._schwarz_operators(x, cv, {}, consts, dp.bc_mask, "asm_btlu",
                                  "f64")
    # the factor's apply and the action: a graph each, the action's
    # kernel launched for its warm-up and its capture alone
    assert counter("dist.graph_captures") - captures == 2
    assert ebe_apply.launches - launches == 2
    eager = dp._jac_action(x, cv, {}, consts, dp.bc_mask)
    assert _rel(Av(v), eager(v)) <= 1e-13
    assert _rel(Av(2.0 * v), eager(2.0 * v)) <= 1e-13
    assert ebe_apply.launches - launches == 2


# The 224^2 distributed cell's shapes (100,352 cells, L = 6, 8 extended
# vectors of 37,974), a vector field's L = 9, and the largest L with few
# rows a slot (many atomics into each y entry)
EBE_SHAPES = [(100_352, 6, 8 * 37_974), (50_000, 9, 150_000),
              (4_000, 32, 3_000)]


@pytest.mark.parametrize("ne, L, n", EBE_SHAPES)
def test_ebe_kernel_matches_plain(cuda, ne, L, n):
    """The element-by-element kernel against its plain version within
    1e-13 relative: each row's sum goes into y with an atomic add, whose
    order changes from launch to launch, so the sums into one entry round
    in another order than index_add's."""
    from proximalgalerkin_torch.ops.ebe import ebe_apply, ebe_apply_reference
    from chip_smoke import ebe_system
    A, gidx, x = ebe_system(cuda, ne, L, n, seed=L)
    yk = ebe_apply(A, gidx, x, n)
    torch.cuda.synchronize()
    assert yk.shape == (n,) and yk.device.type == "cuda"
    assert _rel(yk, ebe_apply_reference(A, gidx, x, n)) <= 1e-13
    # a larger out_size leaves the tail zero
    y2 = ebe_apply(A, gidx, x, n + 5)
    assert _rel(y2[:n], yk) <= 1e-13 and not y2[n:].any()


def test_ebe_kernel_rejects_bad_inputs(cuda):
    from proximalgalerkin_torch.ops.ebe import MAX_L, ebe_apply
    from chip_smoke import ebe_system
    A, gidx, x = ebe_system(cuda, 100, 6, 300, seed=0)
    with pytest.raises(TypeError):
        ebe_apply(A.float(), gidx, x, 300)
    with pytest.raises(TypeError):
        ebe_apply(A, gidx.long(), x, 300)
    with pytest.raises(ValueError):
        big = torch.zeros(10, MAX_L + 1, MAX_L + 1, dtype=torch.float64,
                          device=cuda)
        ebe_apply(big, torch.zeros(10, MAX_L + 1, dtype=torch.int32,
                                   device=cuda), x, 300)
    with pytest.raises(ValueError):
        ebe_apply(A.cpu(), gidx, x, 300)
    with pytest.raises(ValueError):
        ebe_apply(A, gidx.cpu(), x, 300)
    with pytest.raises(ValueError):
        ebe_apply(A.transpose(1, 2), gidx, x, 300)
    with pytest.raises(ValueError):
        ebe_apply(A, gidx, x[::2], 150)


def test_ebe_launch_counter_counts(cuda):
    from proximalgalerkin_torch.ops.ebe import ebe_apply
    from chip_smoke import ebe_system
    A, gidx, x = ebe_system(cuda, 100, 6, 300, seed=1)
    before = ebe_apply.launches
    for _ in range(3):
        ebe_apply(A, gidx, x, 300)
    assert ebe_apply.launches - before == 3
    ebe_apply(A.cpu(), gidx.cpu(), x.cpu(), 300)     # the plain version
    assert ebe_apply.launches - before == 3


def test_recorder_on_under_a_card_only_profile(cuda):
    """The benchmark's first traced solve records the device alone
    (profile(activities=[CUDA])): the recorder is on there, each span
    synchronises the card at its edges and holds its device work, and a
    fast-path solve records its root, Newton steps and inner solves."""
    from torch.profiler import ProfilerActivity, profile
    from proximalgalerkin_torch.core import logging as pglog
    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    solver = P1ObstacleSolver(mesh, device=cuda, alpha_cap=1e2,
                              outer_tol=1e-8, mixed_precision=True, pc="mg")
    a = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert pglog.RECORDER.on()
        with pglog.span("gpu.matmul"):
            for _ in range(20):
                a = a @ a / 2048.0
        r = solver.solve()
    host_only = [g for g in pglog.recorded() if g[0].name == "gpu.matmul"]
    (mm,) = host_only[-1]
    # the span's end waited for the 20 products it enqueued
    assert (mm.end_ns - mm.start_ns) * 1e-9 > 20 * 2 * 2048 ** 3 / 1e15
    group = [g for g in pglog.recorded() if g[0].name == "p1.solve"][-1]
    names = [s.name for s in group]
    assert r.converged and names.count("p1.newton_step") == r.newton_its
    assert names.count("p1.inner_solve") >= r.newton_its
    assert sum(s.counts.get("host_reads", 0) for s in group) > 0


# The block-Thomas apply kernel (csrc/btapply.cu): (S, nb, bs, dtype), S
# None for an unbatched right-hand side. The distributed cell's blocking
# (8 subdomains, 253 x 151) and the disk cell's (97 x 200), float32, an
# unbatched right-hand side, nb = 1 and 2, bs = 1, 33 and 257, more
# systems than the card runs clusters of 16 at once, several tiles a
# product with fewer ring slots than tiles (1,100), the multiphase record's
# f32 apply (1,212), the vector in device memory (4,500) and rows cut into
# column tiles as well (7,200 f64, 15,000 f32)
BT_SHAPES = [(8, 253, 151, torch.float64), (1, 97, 200, torch.float64),
             (2, 51, 200, torch.float32), (None, 20, 33, torch.float64),
             (3, 1, 257, torch.float64), (2, 2, 33, torch.float64),
             (4, 10, 1, torch.float64), (2, 9, 257, torch.float64),
             (40, 8, 64, torch.float64), (1, 12, 1100, torch.float64),
             (1, 6, 1212, torch.float32), (1, 2, 4500, torch.float64),
             (1, 2, 7200, torch.float64), (1, 2, 15000, torch.float32)]


@pytest.mark.parametrize("S, nb, bs, dtype", BT_SHAPES)
def test_bt_apply_kernel_matches_plain(cuda, S, nb, bs, dtype):
    """The block-Thomas apply kernel against its plain version within
    1e-12 relative to max |x| in f64, 1e-5 in f32: each row's sum runs
    in another order than cuBLAS's, and the rounding travels through the
    nb nested steps; chip_smoke.bt_system's factors contract (norms about
    0.5), so the chain does not amplify it."""
    from proximalgalerkin_torch.la.blocktri import bt_apply_reference
    from proximalgalerkin_torch.ops.btapply import bt_apply
    from chip_smoke import bt_system
    Minv, T, L, b = bt_system(cuda, S, nb, bs, dtype, seed=nb * bs)
    xk = bt_apply(Minv, T, L, b)
    torch.cuda.synchronize()
    assert xk.shape == b.shape and xk.dtype == dtype
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(xk, bt_apply_reference(Minv, T, L, b)) <= tol


def test_bt_apply_kernel_gives_the_same_bits_twice(cuda):
    from proximalgalerkin_torch.ops.btapply import bt_apply
    from chip_smoke import bt_system
    for S, nb, bs, dtype in BT_SHAPES[:3]:
        Minv, T, L, b = bt_system(cuda, S, nb, bs, dtype, seed=1)
        assert torch.equal(bt_apply(Minv, T, L, b), bt_apply(Minv, T, L, b))


def test_bt_apply_kernel_replays_in_a_graph(cuda):
    """Captured in a CUDA graph, the launch replays to the eager launch's
    bits, on the right-hand side the static input holds at the replay."""
    from proximalgalerkin_torch.ops.btapply import bt_apply
    from chip_smoke import bt_system
    Minv, T, L, b = bt_system(cuda, 8, 40, 151, torch.float64, seed=2)
    static_b = b.clone()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        bt_apply(Minv, T, L, static_b)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bt_apply(Minv, T, L, static_b)
    for rhs in (b, 2.0 * b - 1.0):
        static_b.copy_(rhs)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, bt_apply(Minv, T, L, rhs))


def test_bt_apply_launch_counter_counts(cuda):
    from proximalgalerkin_torch.la import blocktri
    from proximalgalerkin_torch.ops.btapply import bt_apply
    from chip_smoke import bt_system
    assert blocktri.bt_apply is bt_apply
    Minv, T, L, b = bt_system(cuda, 2, 5, 33, torch.float64, seed=3)
    before = bt_apply.launches
    for _ in range(3):
        bt_apply(Minv, T, L, b)
    assert bt_apply.launches - before == 3
    bt_apply(Minv.cpu(), T.cpu(), L.cpu(), b.cpu())    # the plain version
    assert bt_apply.launches - before == 3
    with pytest.raises(ValueError):
        bt_apply(Minv, T, L, b.cpu())
    with pytest.raises(ValueError):
        bt_apply(Minv.cpu(), T, L, b)


def test_bt_apply_kernel_counter_on_the_btlu_paths(cuda):
    """`bt.apply_kernel`: one in each `bt.apply` span of a dense Thomas
    factor on the card, none with the streamed factor; on the asm_btlu
    path the apply's kernel launches twice when its graph is made (warm-up
    and capture), and each replayed apply counts one."""
    from proximalgalerkin_torch.core import logging as pglog
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_torch.ops.btapply import bt_apply
    from chip_smoke import _dist_obstacle, btlu_case
    for name, per_apply in (("thomas_f32", 1), ("streamed", None)):
        with pglog.tracing():
            btlu_case(name, cuda)
        group = [g for g in pglog.recorded() if g[0].name == "lvpp.solve"][-1]
        applies = [s for s in group if s.name == "bt.apply"]
        assert applies
        assert all(s.counts.get("bt.apply_kernel") == per_apply
                   for s in applies)
    prob, dp = _dist_obstacle(cuda, create_disk_mesh(0.2))
    N = prob.space.num_dofs
    rng = np.random.default_rng(0)
    x, v = dp.scatter(rng.standard_normal(N)), dp.scatter(
        rng.standard_normal(N))
    cv = dp._prep_coeffs({"phi": dp.scatter_cellq(
        prob.problem.coeffs["phi"])} | {
        k: dp.scatter_coeff(k, rng.standard_normal(
            prob.space.spaces["u"].num_dofs)) for k in ("psi_k", "u_k")})
    consts = {"alpha": torch.tensor(3.0, dtype=torch.float64, device=cuda)}
    launches = bt_apply.launches
    _, Minv = dp._schwarz_operators(x, cv, {}, consts, dp.bc_mask,
                                    "asm_btlu", "f64")
    assert bt_apply.launches - launches == 2
    counted = pglog.counter("bt.apply_kernel")
    z = Minv(v)
    assert torch.equal(Minv(v), z)
    assert pglog.counter("bt.apply_kernel") - counted == 2
    assert bt_apply.launches - launches == 2
