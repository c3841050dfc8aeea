"""The port's bound-constrained baselines (solve/optimization.py,
solve/vi.py, models/obstacle_qp.py) against the reference's, on the CPU:
the two cases of tests/test_compare_solvers.py on the port's compare_all,
each solver's count equal to the JAX package's on the same mesh; the QP
operators against the JAX package's at 1e-12; trb_solver,
interior_point_solver and their galahad/ipopt aliases bit-identical
between the packages on the same S, M and f; vi_solve's counts and
solution equal to the JAX package's; and the compare-all CLI."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proximalgalerkin_tpu.mesh import rectangle_mesh as ref_rectangle_mesh
from proximalgalerkin_tpu.models import obstacle_qp as ref_qp
from proximalgalerkin_tpu.solve import optimization as ref_opt

from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.models import obstacle_qp as qp
from proximalgalerkin_torch.models.obstacle import spherical_cap_obstacle
from proximalgalerkin_torch.solve import optimization as opt

NAMES = ("Galahad (TRB)", "LVPP (P1)", "LVPP (P2)", "IPOPT (w. Hessian)",
         "IPOPT (no Hessian)", "SNES-VI")
KW = dict(verbose=False, max_iter=500, tol=1e-4)

# The interior point's divide-by-zero warning (optimization.py:165 of the
# reference, kept as it is) fires on the boundary dofs' equal bounds
pytestmark = pytest.mark.filterwarnings(
    "ignore:divide by zero:RuntimeWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(pkg=torch):
    f = rectangle_mesh if pkg is torch else ref_rectangle_mesh
    return f(12, 12, p0=(-1.0, -1.0), p1=(1.0, 1.0))


@pytest.fixture(scope="module")
def result():
    return (qp.compare_all(_mesh(), device="cpu", **KW),
            ref_qp.compare_all(_mesh(jnp), **KW))


# ------------------------------------ the reference test's cases, ported


def test_all_solvers_ran(result):
    r, _ = result
    for name in NAMES:
        assert name in r.iterations
        assert 0 < r.iterations[name] <= 1000


def test_solutions_agree(result):
    """P1-dof-valued solutions from TRB, IP, VI, LVPP(P1) agree pointwise."""
    r, _ = result
    ref = r.solutions["SNES-VI"]
    for name in ("Galahad (TRB)", "LVPP (P1)", "IPOPT (w. Hessian)"):
        diff = np.abs(r.solutions[name] - ref).max()
        assert diff < 5e-2, (name, diff)


# ------------------------------------------- against the JAX package


@pytest.mark.parametrize("name", NAMES)
def test_counts_equal_reference(result, name):
    r, rr = result
    assert r.iterations[name] == rr.iterations[name]
    if name != "IPOPT (no Hessian)":
        # the other five reach their tolerance: their solutions agree.
        # The interior point without the Hessian stops at its cap of 20
        # steps a barrier level, mid-descent, where the last bits of S
        # (1.8e-15 apart between the packages) move the iterate; fed the
        # same S it is bit-identical (test_interior_point_bit_identical)
        assert np.abs(r.solutions[name]
                      - np.asarray(rr.solutions[name])).max() <= 1e-10


def test_table(result):
    r, rr = result
    assert r.table() == rr.table()


@pytest.mark.parametrize("degree", [1, 2])
def test_qp_operators_match_reference(degree):
    V, S, M = qp.assemble_qp_operators(_mesh(), degree, device="cpu")
    rV, rS, rM = ref_qp.assemble_qp_operators(_mesh(jnp), degree)
    np.testing.assert_array_equal(V.dof_points, rV.dof_points)
    for a, b in ((S, rS), (M, rM)):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert abs(a - b).max() <= 1e-12 * abs(b).max()


@pytest.fixture(scope="module")
def qp_data():
    """The JAX package's S and M on the 12^2 rectangle, the bounds of
    compare_all, a random load f, and the start point."""
    V, S, M = ref_qp.assemble_qp_operators(_mesh(jnp), 1)
    n = V.num_dofs
    phi = spherical_cap_obstacle(V.dof_points.T)
    bd = np.asarray(V.boundary_dofs())
    lb, ub = phi.copy(), np.full(n, np.inf)
    lb[bd] = ub[bd] = 0.0
    f = np.random.default_rng(0).standard_normal(n) * 0.5
    return S, M, f, lb, ub, np.maximum(lb, 0.0)


SOLVERS = {
    "trb": lambda m, P, x0, b: m.trb_solver(P, x0, b, max_iter=500,
                                            tol=1e-4),
    "trb_no_hessian": lambda m, P, x0, b: m.trb_solver(
        P, x0, b, use_hessian=False, max_iter=50, tol=1e-4),
    "ip_hessian": lambda m, P, x0, b: m.interior_point_solver(
        P, x0, b, max_iter=500, tol=1e-4),
    "ip_no_hessian": lambda m, P, x0, b: m.interior_point_solver(
        P, x0, b, max_iter=500, tol=1e-4, activate_hessian=False),
    "galahad_solver": lambda m, P, x0, b: m.galahad_solver(
        P, x0, b, log_level=0, max_iter=500, tol=1e-4),
    "ipopt_solver": lambda m, P, x0, b: (m.ipopt_solver(
        P, x0, b, max_iter=500, tol=1e-4), None),
}


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_optimization_bit_identical(qp_data, solver):
    """The copied numpy/scipy solvers give the reference's bits on the
    same S, M and f (with a load, so TRB takes many steps)."""
    S, M, f, lb, ub, x0 = qp_data
    run = SOLVERS[solver]
    P, rP = qp.ObstacleQP(S, M, f), ref_qp.ObstacleQP(S, M, f)
    x, it = run(opt, P, x0.copy(), (lb, ub))
    rx, rit = run(ref_opt, rP, x0.copy(), (lb, ub))
    assert it == rit
    np.testing.assert_array_equal(x, rx)
    assert P.total_iteration_count == rP.total_iteration_count


def test_vi_solve_matches_reference():
    """vi_solve on the SNES-VI problem of compare_all with a load: the
    same iteration count and reason, x within 1e-10, x on the device."""
    from proximalgalerkin_tpu.assembly import VolumeForm as RefVolumeForm
    from proximalgalerkin_tpu.solve.nonlinear import \
        NonlinearProblem as RefNonlinearProblem
    from proximalgalerkin_tpu.solve.vi import vi_solve as ref_vi_solve
    from proximalgalerkin_tpu.spaces import DirichletBC as RefDirichletBC
    from proximalgalerkin_tpu.spaces import FunctionSpace as RefFS
    from proximalgalerkin_tpu.spaces import MixedSpace as RefMS

    from proximalgalerkin_torch.assembly import VolumeForm
    from proximalgalerkin_torch.solve.nonlinear import NonlinearProblem
    from proximalgalerkin_torch.solve.vi import vi_solve
    from proximalgalerkin_torch.spaces import (DirichletBC, FunctionSpace,
                                               MixedSpace)

    out = []
    for mesh, VF, NP, DBC, FS, MS, vi, kw in (
            (_mesh(), VolumeForm, NonlinearProblem, DirichletBC,
             FunctionSpace, MixedSpace, vi_solve, {"device": "cpu"}),
            (_mesh(jnp), RefVolumeForm, RefNonlinearProblem, RefDirichletBC,
             RefFS, RefMS, ref_vi_solve, {})):
        V = FS.create(mesh, 1)
        space = MS([("u", V)])
        form = VF(space, lambda x, u, gu, c, gc, k: {"u": (-2.0, gu["u"])},
                  quadrature_degree=2, **kw)
        nlp = NP(form, [DBC.from_marker("u", V, value=0.0)])
        phi = spherical_cap_obstacle(V.dof_points.T)
        out.append(vi(nlp, np.zeros(V.num_dofs), phi, None,
                      {"snes_atol": 1e-8, "snes_rtol": 1e-8,
                       "snes_max_it": 1000}))
    (x, reason, it), (rx, rreason, rit) = out
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert (reason, it) == (rreason, rit)
    assert it > 1
    rx = np.asarray(rx)
    assert np.abs(x.numpy() - rx).max() <= 1e-10 * np.abs(rx).max()


def test_cli(capsys):
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    main(["compare-all", "--disk-res", "0.3", "--device", "cpu"])
    out = capsys.readouterr().out.strip()
    r = qp.compare_all(create_disk_mesh(0.3), verbose=False, device="cpu")
    assert out.endswith(r.table())
