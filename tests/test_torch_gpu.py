"""Tests of the port's CUDA kernels; they need a card and skip without
one. This file imports no jax, so on a machine with a card and without
jax it runs alone, without the suite's conftest:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
from proximalgalerkin_torch.ops import dia_cg, mgfused
from proximalgalerkin_torch.ops.dia_spmv import dia_spmv, dia_spmv_reference

from chip_smoke import dia_cg_system, grids_on, p1_operator, residual_ratio

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA only")
    return torch.device("cuda")


def _rel(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


# Every split of the V-cycle (mgfused.level_plan): all levels in the
# one-block tail (12, 17, 33, 35, 65), one level too large for it and
# swept by grid kernels (100), grid levels above the tail (129, 257,
# 1025), grid levels above a coarsest level swept by grid kernels (67:
# levels 67, 34; 131: levels 131, 66)
@pytest.mark.parametrize("m", [12, 17, 33, 35, 65, 67, 100, 129, 131, 257,
                               1025])
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
