"""The port's P1 obstacle solver (models/obstacle_p1.py) against the
reference's on the same problems, on the CPU. The reference's mixed +
mg path runs its XLA MG-PCG here (its Pallas kernel is TPU-only); the
port's runs the plain version of its fused MG-PCG. The reference's own
test shows the two contracts give the same Newton trajectory
(tests/test_mgfused.py:127-149), which is what is checked here too."""

import json

import numpy as np
import pytest

from proximalgalerkin_tpu.mesh import rectangle_mesh as ref_rectangle_mesh
from proximalgalerkin_tpu.models.obstacle_p1 import \
    P1ObstacleSolver as RefSolver

from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
from proximalgalerkin_torch.ops import dia_cg

MIXED_MG = dict(alpha_cap=1e2, outer_tol=1e-8, mixed_precision=True,
                pc="mg")
MIXED_JACOBI = dict(alpha_cap=1e2, outer_tol=1e-8, mixed_precision=True,
                    pc="jacobi")


def _meshes(n, **kw):
    kw = dict(p0=(-1.0, -1.0), p1=(1.0, 1.0), **kw)
    return ref_rectangle_mesh(n, n, **kw), rectangle_mesh(n, n, **kw)


@pytest.fixture(scope="module")
def ref_mixed_mg_32():
    """The reference's mixed + mg solver and full solve at 32^2."""
    mr, _ = _meshes(32)
    s = RefSolver(mr, **MIXED_MG)
    return s, s.solve(max_outer=100)


@pytest.mark.parametrize("operator", ["assembled", "from_arrays"])
def test_mixed_mg_trajectory_matches_reference(ref_mixed_mg_32, operator):
    """Mixed + mg at 32^2, six outer steps: the same Newton counts and u
    within the reference's own fused-vs-XLA bound (atol 5e-9), on an
    independently assembled operator and on the reference's arrays."""
    sr, _ = ref_mixed_mg_32
    r_ref = sr.solve(max_outer=6)
    _, mt = _meshes(32)
    if operator == "assembled":
        st = P1ObstacleSolver(mt, device="cpu", **MIXED_MG)
    else:
        st = P1ObstacleSolver.from_arrays(
            mt, A_csr_host=sr.A_csr_host, dia_offsets=sr.dia.offsets,
            dia_data=np.asarray(sr.dia.data), M_L=np.asarray(sr.M_L),
            phi=np.asarray(sr.phi), interior=np.asarray(sr.interior),
            device="cpu", **MIXED_MG)
    r = st.solve(max_outer=6)
    assert r.newton_per_outer == r_ref.newton_per_outer
    assert np.allclose(r.u, r_ref.u, atol=5e-9)


def test_mixed_mg_full_solve_matches_reference(ref_mixed_mg_32):
    sr, r_ref = ref_mixed_mg_32
    _, mt = _meshes(32)
    st = P1ObstacleSolver(mt, device="cpu", **MIXED_MG)
    r = st.solve(max_outer=100)
    assert r.converged and r_ref.converged
    assert r.outer_iterations == r_ref.outer_iterations
    assert np.linalg.norm(r.u - r_ref.u) <= 1e-6 * np.linalg.norm(r_ref.u)
    assert float((r.u - st.phi.numpy()).min()) > -1e-10


def test_f64_jacobi_matches_reference_48():
    mr, mt = _meshes(48)
    r_ref = RefSolver(mr).solve()
    st = P1ObstacleSolver(mt, device="cpu")
    r = st.solve()
    assert r.converged and r_ref.converged
    assert r.newton_per_outer == r_ref.newton_per_outer
    assert np.abs(r.u - r_ref.u).max() <= 1e-9
    assert float((r.u - st.phi.numpy()).min()) > -1e-10
    assert np.abs(r.u[np.asarray(st.V.boundary_dofs())]).max() == 0.0


def test_f64_mg_matches_jacobi_and_reference():
    mr, mt = _meshes(32)
    r_j = P1ObstacleSolver(mt, device="cpu", pc="jacobi").solve()
    r_m = P1ObstacleSolver(mt, device="cpu", pc="mg").solve()
    assert r_m.converged
    assert np.linalg.norm(r_m.u - r_j.u) < 1e-7 * np.linalg.norm(r_j.u)
    assert r_m.cg_its_total < r_j.cg_its_total
    r_ref = RefSolver(mr, pc="mg").solve(max_outer=100)
    assert r_m.newton_per_outer == r_ref.newton_per_outer


@pytest.mark.parametrize("kw", [
    dict(mixed_precision=True, pc="jacobi"),
    dict(mixed_precision=True, pc="mg", cg_forcing="ew"),
], ids=["mixed_jacobi", "mixed_mg_ew"])
def test_other_mixed_branches_match_reference(kw):
    """The mixed Jacobi-CG branch (the port's fused DIA-CG against the
    reference's XLA Jacobi-CG) and Eisenstat-Walker forcing: the same
    Newton counts as the reference, u within 5e-9."""
    mr, mt = _meshes(32)
    r_ref = RefSolver(mr, **kw).solve(max_outer=6)
    r = P1ObstacleSolver(mt, device="cpu", **kw).solve(max_outer=6)
    assert r.newton_per_outer == r_ref.newton_per_outer
    assert np.allclose(r.u, r_ref.u, atol=5e-9)


def test_dia_and_ell_paths_agree_on_crossed_mesh():
    _, mt = _meshes(12, diagonal="crossed")
    r_dia = P1ObstacleSolver(mt, device="cpu").solve()
    r_ell = P1ObstacleSolver(mt, device="cpu", use_dia=False).solve()
    assert r_dia.converged and r_ell.converged
    assert np.abs(r_dia.u - r_ell.u).max() < 1e-8


@pytest.fixture(scope="module")
def ref_mixed_jacobi_fused_32():
    """The reference's mixed + jacobi solver at 32^2 with its fused DIA-CG
    kernels forced into Pallas interpret mode, six outer steps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PGTPU_PALLAS", "force")
        mr, _ = _meshes(32)
        s = RefSolver(mr, **MIXED_JACOBI)
        assert s._fused_cg is not None
        return s, s.solve(max_outer=6)


@pytest.mark.parametrize("operator", ["assembled", "from_arrays"])
def test_mixed_jacobi_matches_reference_fused_kernels(
        ref_mixed_jacobi_fused_32, operator):
    """Mixed + jacobi at 32^2: the port's fused DIA-CG (its plain version
    here) against the reference's fused DIA-CG kernels in interpret mode:
    the same Newton counts, CG totals within 3%, u within atol 5e-9."""
    sr, r_ref = ref_mixed_jacobi_fused_32
    _, mt = _meshes(32)
    if operator == "assembled":
        st = P1ObstacleSolver(mt, device="cpu", **MIXED_JACOBI)
    else:
        st = P1ObstacleSolver.from_arrays(
            mt, A_csr_host=sr.A_csr_host, dia_offsets=sr.dia.offsets,
            dia_data=np.asarray(sr.dia.data), M_L=np.asarray(sr.M_L),
            phi=np.asarray(sr.phi), interior=np.asarray(sr.interior),
            device="cpu", **MIXED_JACOBI)
    before = dia_cg.solve.launches
    r = st.solve(max_outer=6)
    assert dia_cg.solve.launches == before       # no kernel on the CPU
    assert r.newton_per_outer == r_ref.newton_per_outer
    assert abs(r.cg_its_total - r_ref.cg_its_total) <= 0.03 * \
        r_ref.cg_its_total
    assert np.allclose(r.u, r_ref.u, atol=5e-9)


def test_solve_fused_matches_solve():
    """tests/test_obstacle_p1.py:124 for the port: solve_fused gives the
    outer and Newton totals of solve() and bitwise the same u."""
    _, mt = _meshes(32)
    s = P1ObstacleSolver(mt, device="cpu", **MIXED_JACOBI)
    a = s.solve()
    b = s.solve_fused()
    assert b.converged and a.converged
    assert b.outer_iterations == a.outer_iterations
    assert b.newton_its == a.newton_its
    assert b.cg_its_total == a.cg_its_total
    assert b.newton_per_outer == [] and len(b.increments) == 1
    assert np.abs(a.u - b.u).max() == 0.0


def test_rejected_configurations():
    _, mt = _meshes(8)
    with pytest.raises(ValueError, match="mixed_precision"):
        P1ObstacleSolver(mt, device="cpu", cg_forcing="ew")
    with pytest.raises(ValueError, match="lattice"):
        P1ObstacleSolver(rectangle_mesh(8, 8, diagonal="crossed"),
                         device="cpu", pc="mg")
    with pytest.raises(NotImplementedError, match="affine triangles"):
        P1ObstacleSolver(rectangle_mesh(4, 4, cell_type="quadrilateral"),
                         device="cpu")


def test_alpha_schedule_matches_reference():
    mr, mt = _meshes(4)
    np.testing.assert_array_equal(
        P1ObstacleSolver(mt, device="cpu").alpha_schedule(40),
        RefSolver(mr).alpha_schedule(40))


@pytest.mark.parametrize("pc,fused", [("mg", False), ("jacobi", True)])
def test_bench_cli_on_cpu(pc, fused, capsys):
    """`bench` runs both inner solves and both entry points and prints
    the reference bench's JSON keys."""
    from proximalgalerkin_torch.cli import main
    main(["bench", "-n", "8", "--device", "cpu", "--pc", pc]
         + (["--fused"] if fused else []))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"] and out["n"] == 8 and out["dofs"] == 162
    assert out["cg_its"] > 0 and out["feasibility"] >= -1e-10
    assert set(out) == {"mode", "elapsed", "n", "dofs", "newton", "outer",
                        "converged", "feasibility", "cg_its", "membw_gbps",
                        "esz"}
