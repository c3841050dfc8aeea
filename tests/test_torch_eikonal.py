"""The port's eikonal model (models/eikonal.py) and its meshes
(mesh/manifolds.py, mesh/parametric.py) against the reference's, on the
CPU: the seven cases of tests/test_eikonal.py through both packages —
LVPP and per-step Newton counts identical, u within 1e-10 (LU) or 1e-8
(MINRES) — with the reference test's own checks on the port's solutions;
the Möbius strip and the parametric meshes bit-identical to the
reference's; and the eikonal CLI."""

import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.mesh import manifolds as ref_manifolds
from proximalgalerkin_tpu.mesh import parametric as ref_parametric
from proximalgalerkin_tpu.mesh.unstructured import \
    create_star_mesh as ref_star
from proximalgalerkin_tpu.models.eikonal import solve_eikonal as ref_solve

from proximalgalerkin_torch.mesh import manifolds, parametric
from proximalgalerkin_torch.mesh.unstructured import create_star_mesh
from proximalgalerkin_torch.models.eikonal import solve_eikonal

SCHUR = {"ksp_type": "minres", "ksp_rtol": 1e-10, "ksp_atol": 1e-12,
         "ksp_max_it": 3000}
MATFREE = {"ksp_type": "minres", "pc_type": "jacobi", "mat_type": "matfree",
           "ksp_rtol": 1e-9, "ksp_max_it": 4000, "snes_rtol": 1e-8,
           "snes_max_it": 50}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(r, rr, tol):
    """Counts identical, u within tol relative to the reference's."""
    assert r.lvpp_iterations == rr.lvpp_iterations
    assert r.newton_iterations == rr.newton_iterations
    assert r.converged == rr.converged
    ru = np.asarray(rr.u)
    assert np.abs(r.u - ru).max() <= tol * np.abs(ru).max()


def _same_mesh(m, rm):
    assert m.cell_type == rm.cell_type
    np.testing.assert_array_equal(m.points, rm.points)
    np.testing.assert_array_equal(m.cells, rm.cells)


def test_mobius_mesh():
    m = manifolds.mobius_strip(24, 4, width=0.4)
    assert m.gdim == 3 and m.tdim == 2
    assert m.num_cells == 24 * 4
    # a single boundary curve: 2 * ns boundary facets
    assert len(m.exterior_facets) == 2 * 24
    for kw in ({"ns": 24, "nt": 4, "width": 0.4}, {"ns": 48, "nt": 6},
               {"ns": 10, "nt": 3, "cell_type": "triangle"}):
        _same_mesh(manifolds.mobius_strip(**kw),
                   ref_manifolds.mobius_strip(**kw))


def test_parametric_meshes_match_reference():
    """mesh/parametric.py bit-identical to the reference's: the ball of
    the eikonal variant and the half-disk and half-sphere specimens."""
    _same_mesh(parametric.create_ball_mesh(res=0.45),
               ref_parametric.create_ball_mesh(res=0.45))
    for fn, kw in (("create_half_disk", {"res": 0.08}),
                   ("create_half_sphere", {"res": 0.2})):
        t = getattr(parametric, fn)(**kw)
        rt = getattr(ref_parametric, fn)(**kw)
        _same_mesh(t.mesh, rt.mesh)
        assert t.facet_tags == rt.facet_tags
        assert t.regions == rt.regions


@pytest.fixture(scope="module")
def solved():
    return (solve_eikonal(ns=24, nt=4, verbose=False, device="cpu"),
            ref_solve(ns=24, nt=4, verbose=False))


def test_converges(solved):
    r, rr = solved
    assert r.converged
    assert r.lvpp_iterations < 60
    assert r.total_newton < 150
    _same(r, rr, 1e-10)


def test_distance_function(solved):
    """|grad u| = 1 with u = 0 on the strip edge: the maximum equals the
    distance from edge to centerline = width/2 = 0.2."""
    r, _ = solved
    assert abs(r.u.max() - 0.2) < 0.02
    assert r.u.min() > -1e-3


def test_minres_matfree_matches_lu(solved):
    """MINRES + |diag| Jacobi on the matrix-free saddle Jacobian (the
    reference's ex40 solver path) against the LU path and the JAX
    package, over the first 5 of the 20 LVPP steps: per-step Newton
    counts equal LU's and the JAX package's, u within 1e-6 of LU's and
    1e-8 of the JAX package's. (The port's matrix-free action is one
    eager torch.func jvp a MINRES iteration, about 10 ms on one CPU
    thread: the whole trajectory takes about 14 minutes on the CPU.)"""
    kw = dict(ns=24, nt=4, verbose=False, max_iterations=5)
    r = solve_eikonal(device="cpu", solver_options=MATFREE, **kw)
    r_lu = solve_eikonal(device="cpu", **kw)
    rr = ref_solve(solver_options=MATFREE, **kw)
    assert r.lvpp_iterations == r_lu.lvpp_iterations == 5
    assert r.newton_iterations == r_lu.newton_iterations
    assert np.abs(r.u - r_lu.u).max() < 1e-6
    _same(r, rr, 1e-8)


def test_eikonal_schur_minres_matches_lu_counts():
    """The block-Schur MINRES default (la/schur.py, the ex40.cpp:261-281
    recipe) reproduces the LU path's outer/Newton counts exactly, and the
    JAX package's Schur-MINRES run."""
    r_lu = solve_eikonal(ns=16, nt=3, verbose=False, device="cpu")
    r_sc = solve_eikonal(ns=16, nt=3, verbose=False, device="cpu",
                         solver_options=SCHUR)
    assert r_sc.converged
    assert r_sc.newton_iterations == r_lu.newton_iterations
    _same(r_sc, ref_solve(ns=16, nt=3, verbose=False, solver_options=SCHUR),
          1e-8)


def test_star_domain_eikonal():
    """ex40p's planar star-domain variant: the LVPP eikonal solution
    approximates the distance to the star boundary."""
    mesh = create_star_mesh(0.12)
    _same_mesh(mesh, ref_star(0.12))
    r = solve_eikonal(mesh=mesh, verbose=False, device="cpu")
    _same(r, ref_solve(mesh=ref_star(0.12), verbose=False), 1e-10)
    u = r.u
    assert r.lvpp_iterations < 40
    assert u.min() > -0.02
    # the maximum distance-to-boundary of the 5-star (R=1, r=0.45) is
    # attained at the center
    a, b = np.array([0.0, 1.0]), 0.45 * np.array(
        [np.cos(np.pi / 2 + np.pi / 5), np.sin(np.pi / 2 + np.pi / 5)])
    t = -np.dot(a, b - a) / np.dot(b - a, b - a)
    d_center = np.linalg.norm(a + t * (b - a))
    assert abs(u.max() - d_center) < 0.1 * d_center


def test_ball_domain_eikonal():
    """ex40p's solid-ball variant: 3D tet eikonal; the distance at the
    center approximates R."""
    mesh = parametric.create_ball_mesh(res=0.45)
    r = solve_eikonal(mesh=mesh, verbose=False, device="cpu")
    _same(r, ref_solve(mesh=ref_parametric.create_ball_mesh(res=0.45),
                       verbose=False), 1e-10)
    u = r.u
    assert r.lvpp_iterations < 40
    assert u.min() > -0.05
    assert 0.5 < u.max() <= 1.05


def test_cli_eikonal(capsys):
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_tpu.cli import main as ref_main
    argv = ["--opt", "snes_max_it=30", "eikonal", "--ns", "12", "--nt", "3"]
    ref_main(argv)
    ref_lines = capsys.readouterr().out.strip().splitlines()
    main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == ref_lines[-1]
    assert lines[-1].startswith("LVPP ")
