"""The port's Monge–Ampère model (models/monge_ampere.py) and its point
evaluation (utils/pointeval.py) against the reference's, on the CPU: the
three cases of tests/test_monge_ampere.py on the port, the p- and
h-refinement sweeps through both packages (Newton counts and dofs
identical, L2 errors within 1e-8 relative), point evaluation equal to the
reference's, and the monge-ampere CLI."""

import ast

import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.models import monge_ampere as ref_ma
from proximalgalerkin_tpu.utils import pointeval as ref_pointeval

from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.models.monge_ampere import (
    h_refinement_sweep, p_refinement_sweep, solve_monge_ampere_degree)
from proximalgalerkin_torch.spaces import FunctionSpace
from proximalgalerkin_torch.utils import pointeval


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweep():
    return (p_refinement_sweep(3, 5, verbose=False, device="cpu"),
            ref_ma.p_refinement_sweep(3, 5, verbose=False))


def _same_sweep(s, rs):
    assert s.degrees == rs.degrees
    assert s.dofs == rs.dofs
    assert s.newton_its == rs.newton_its
    np.testing.assert_allclose(s.errors, rs.errors, rtol=1e-8, atol=0.0)


def test_errors_decrease_exponentially(sweep):
    e = sweep[0].errors
    assert e[0] < 0.1
    # each degree gains at least ~4x accuracy (spectral convergence)
    assert all(e[i + 1] < e[i] / 4 for i in range(len(e) - 1)), e


def test_warm_start_reduces_newton(sweep):
    s = sweep[0]
    assert s.newton_its[-1] <= s.newton_its[0]
    assert all(n <= 15 for n in s.newton_its)


def test_p_sweep_matches_reference(sweep):
    _same_sweep(*sweep)


def test_convexity_of_solution():
    """The latent map guarantees an SPD discrete Hessian: psi finite and
    det expm(psi) = exp(tr psi) positive at the dofs; the solve matches
    the JAX package's (Newton count, x within 1e-8 relative)."""
    space, x, its, err, mesh = solve_monge_ampere_degree(4, verbose=False,
                                                         device="cpu")
    Psi = x[space.slice_of("Psi")].numpy().reshape(-1, 3)
    assert np.isfinite(Psi).all()
    assert (np.exp(Psi[:, 0] + Psi[:, 2]) > 0).all()
    _, rx, rits, rerr, _ = ref_ma.solve_monge_ampere_degree(4, verbose=False)
    rx = np.asarray(rx)
    assert its == rits
    assert np.abs(x.numpy() - rx).max() <= 1e-8 * np.abs(rx).max()
    assert abs(err - rerr) <= 1e-8 * rerr


def test_h_sweep_matches_reference():
    _same_sweep(h_refinement_sweep(2, 3, verbose=False, device="cpu"),
                ref_ma.h_refinement_sweep(2, 3, verbose=False))


def test_point_evaluation_matches_reference():
    """evaluate() of a P3 scalar and a P2 vector field at random points
    (and at another space's dof points) equals the reference's."""
    mesh = rectangle_mesh(3, 2, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.0, 1.0, (40, 2))
    for deg, m in ((3, 1), (2, 2)):
        V = FunctionSpace.create(mesh, deg, value_size=m)
        z = rng.standard_normal(V.num_dofs)
        got = pointeval.evaluate(V, z, pts)
        np.testing.assert_array_equal(got,
                                      ref_pointeval.evaluate(V, z, pts))
        W = FunctionSpace.create(mesh, deg + 1, value_size=m)
        np.testing.assert_array_equal(
            pointeval.interpolate_nonmatching(V, z, W),
            ref_pointeval.interpolate_nonmatching(V, z, W))
    with pytest.raises(ValueError, match="outside"):
        pointeval.evaluate(V, z, np.array([[2.0, 0.0]]))


def test_cli_monge_ampere(capsys):
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_tpu.cli import main as ref_main
    argv = ["monge-ampere", "--kmin", "2", "--kmax", "3"]
    ref_main(argv)
    ref_lines = capsys.readouterr().out.strip().splitlines()
    main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(ref_lines)
    assert [ln.split(": ")[0] for ln in lines[:-1]] == \
        [ln.split(": ")[0] for ln in ref_lines[:-1]]
    assert lines[-1].startswith("Errors [")
    np.testing.assert_allclose(ast.literal_eval(lines[-1][len("Errors "):]),
                               ast.literal_eval(ref_lines[-1][len("Errors "):]),
                               rtol=1e-8, atol=0.0)
