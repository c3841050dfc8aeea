"""The port's multiphase Cahn–Hilliard model (models/multiphase.py)
against the reference's, on the CPU, at the reference test's size (N = 10,
two implicit-Euler steps of dt 1e-4): the initial condition bit-identical,
per-step Newton/LVPP counts and u equal to the reference's run, the
reference test's simplex, mass and bookkeeping checks on the port's
solution, the fused lagged-btlu Newton (Thomas and cyclic reduction)
against the default LU path, the EllSplit data against full assembly, the
csr_data_override against direct jacfwd assembly, the closed-form softmax
Jacobian against jax.nn.softmax's, and the multiphase CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.mesh import unit_square_mesh as ref_mesh
from proximalgalerkin_tpu.models.multiphase import \
    initial_condition as ref_initial_condition
from proximalgalerkin_tpu.models.multiphase import \
    solve_multiphase as ref_solve
from proximalgalerkin_tpu.spaces import FunctionSpace as RefFunctionSpace

from proximalgalerkin_torch.mesh import unit_square_mesh
from proximalgalerkin_torch.models import multiphase as mpmod
from proximalgalerkin_torch.models.multiphase import (initial_condition,
                                                      solve_multiphase)
from proximalgalerkin_torch.spaces import FunctionSpace

KW = dict(N=10, M=10, tau0=1e-4, T=2e-4, stopping_tol=1e-5, verbose=False)
FUSED = {"snes_fused": True, "ksp_type": "preonly", "pc_type": "btlu",
         "ksp_rtol": 1e-9, "pc_factor_dtype": "f64", "pc_factor_lag": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    """(port, reference) with the default options (host LU with the split
    CSR assembly)."""
    return solve_multiphase(device="cpu", **KW), ref_solve(**KW)


def _close(u, ref, rtol=1e-8):
    return np.linalg.norm(np.asarray(u) - ref) < rtol * max(
        1.0, np.linalg.norm(ref))


def _problem(monkeypatch, solver_options=None):
    """The port's NonlinearProblem of a multiphase setup (T = 0: no time
    step is taken), with the reference's random state of the split tests
    and random coefficient fields."""
    probs = []
    orig = mpmod.NonlinearProblem

    class Rec(orig):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            probs.append(self)

    monkeypatch.setattr(mpmod, "NonlinearProblem", Rec)
    solve_multiphase(N=10, M=10, tau0=1e-4, T=0.0, verbose=False,
                     device="cpu", solver_options=solver_options)
    p = probs[0]
    rng = np.random.default_rng(7)
    n = p.space.spaces["u"].num_dofs
    p.update(coeffs={k: torch.as_tensor(rng.random(n))
                     for k in ("u_prev", "psi_old", "u_old")})
    x = torch.as_tensor(rng.standard_normal(p.space.num_dofs) * 0.4)
    return p, x


def test_initial_condition_partition():
    mesh = unit_square_mesh(10, 10, diagonal="crossed")
    C = FunctionSpace.create(mesh, 1, value_size=4)
    u0 = initial_condition(C)
    rC = RefFunctionSpace.create(ref_mesh(10, 10, diagonal="crossed"), 1,
                                 value_size=4)
    np.testing.assert_array_equal(u0, ref_initial_condition(rC))
    u0 = u0.reshape(-1, 4)
    assert np.allclose(u0.sum(axis=1), 1.0)
    assert set(np.unique(u0)) <= {0.0, 1.0}
    # all four species present
    assert all(u0[:, m].max() == 1.0 for m in range(4))


def test_matches_reference(solved):
    """Per-step Newton and LVPP counts identical to the reference's run, u
    within 1e-8 (the reference's fused-vs-default bound)."""
    r, rr = solved
    assert list(r.newton_iterations) == list(rr.newton_iterations)
    assert list(r.lvpp_iterations) == list(rr.lvpp_iterations)
    assert _close(r.u, np.asarray(rr.u))
    np.testing.assert_allclose([m[0] for m in r.mass_history],
                               [m[0] for m in rr.mass_history], atol=1e-12)


def test_simplex_constraint(solved):
    u = solved[0].u.reshape(-1, 4)
    # weak simplex enforcement: row sums ~ 1, values in [0,1] up to
    # projection error
    assert np.abs(u.sum(axis=1) - 1.0).max() < 1e-6
    assert u.min() > -0.15 and u.max() < 1.15


def test_mass_conserved(solved):
    m = [float(x[0]) for x in solved[0].mass_history]
    assert np.allclose(m, 1.0, atol=1e-10)


def test_iteration_bookkeeping(solved):
    r = solved[0]
    assert len(r.newton_iterations) == 2
    assert (r.lvpp_iterations >= 1).all()
    assert (r.newton_iterations >= r.lvpp_iterations).all()


@pytest.mark.parametrize("algo", ["thomas", "cr"])
def test_fused_btlu_matches_default(solved, algo):
    """The fused lagged-btlu Newton (f64 factor recursion, f32-cast apply,
    the factor carried across Newton steps and alpha-loop solves,
    refactored only when the stale factor's refinement misses ksp
    tolerance), with the Thomas and the cyclic-reduction factor,
    reproduces the default trajectory: counts identical, u within 1e-8,
    mass conserved to 1e-10."""
    opts = dict(FUSED, pc_factor_algo=algo)
    r2 = solve_multiphase(device="cpu", solver_options=opts, **KW)
    r = solved[0]
    assert list(r2.newton_iterations) == list(r.newton_iterations)
    assert list(r2.lvpp_iterations) == list(r.lvpp_iterations)
    assert _close(r2.u, r.u)
    m = [float(x[0]) for x in r2.mass_history]
    assert np.allclose(m, 1.0, atol=1e-10)


def test_ell_split_matches_full_assembly(monkeypatch):
    """The device EllSplit (closed-form softmax Jacobian scattered into
    the affine ELL data) equals the full-jacfwd ELL assembly to roundoff
    (1e-13 of the largest entry)."""
    p, x = _problem(monkeypatch, FUSED)
    split = p.ell_split
    cc, kk = dict(p.coeffs), dict(p.consts)
    data_split = split.lin_data(cc, kk) + split.nl_core(x, cc, kk,
                                                        split.extra)
    data_full = p.ell_matrix.assemble(p.form.element_matrices(x, cc, kk))
    scale = max(1.0, float(data_full.abs().max()))
    assert float((data_split - data_full).abs().max()) < 1e-13 * scale


def test_split_jacobian_matches_direct_jacfwd(monkeypatch):
    """The csr_data_override (cached affine CSR data + softmax-only
    rediff on the psi subspace) reproduces the full-jacfwd Jacobian to
    1e-14 of its largest entry."""
    p, x = _problem(monkeypatch)
    A_split = p.jacobian_scipy(x)
    p.csr_data_override = None
    A_direct = p.jacobian_scipy(x)
    assert abs(A_split - A_direct).max() < 1e-14 * max(
        1.0, abs(A_direct).max())


def test_softmax_jacobian_matches_jax():
    """d(-softmax)/dpsi in nl_core's closed form s s^T - diag(s), with
    s = torch.softmax, and torch.func.jacfwd of the residual's
    torch.softmax, against jax.jacfwd(jax.nn.softmax), also at saturated
    arguments (the psi block saturates to ~1e-9 in the record runs):
    within 1e-15 absolute (the entries are at most 1/4)."""
    rng = np.random.default_rng(11)
    psis = [rng.standard_normal(4) * 3.0, np.array([30.0, -30.0, 0.0, 1.0]),
            np.array([-25.0, -25.0, -25.0, 20.0]), np.zeros(4)]
    for psi in psis:
        ref = -np.asarray(jax.jacfwd(jax.nn.softmax)(jnp.asarray(psi)))
        t = torch.as_tensor(psi)
        s = torch.softmax(t, dim=-1)
        closed = (s[:, None] * s[None, :] - torch.diag(s)).numpy()
        auto = -torch.func.jacfwd(lambda v: torch.softmax(v, dim=-1))(
            t).numpy()
        assert np.abs(closed - ref).max() <= 1e-15, psi
        assert np.abs(auto - ref).max() <= 1e-15, psi


def test_cli_multiphase(capsys):
    """The multiphase subcommand prints the reference CLI's lines (one
    4^2 step)."""
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_tpu.cli import main as ref_main
    argv = ["multiphase", "-N", "4", "-M", "4", "--dt", "1e-4", "--T",
            "1e-4"]
    ref_main(argv)
    ref_lines = capsys.readouterr().out.strip().splitlines()
    main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2:] == ref_lines[-2:]
    assert lines[-2].startswith("Newton iterations:")


def test_fused_bt_linesearch_evaluates_only_its_backtracks():
    """The fused 'bt' line search (the multiphase default) evaluates the
    residual once at the full step and once a backtrack, as the
    reference's while_loop does, and not a masked 64-iteration chunk of
    residuals: one evaluation where the full Newton step is accepted
    (a linear residual), a few where it backtracks (atan from x = 3)."""
    from proximalgalerkin_torch.solve.nonlinear import _fused_linesearch
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((6, 6)) + 6.0 * np.eye(6))
    b = torch.as_tensor(rng.standard_normal(6))
    for residual, x, dx in (
            (lambda z: A @ z - b, torch.zeros(6, dtype=torch.float64),
             torch.linalg.solve(A, b)),
            (torch.atan, torch.full((6,), 3.0, dtype=torch.float64),
             -torch.atan(torch.full((6,), 3.0, dtype=torch.float64)) * 10.0)):
        calls = []

        def fsq(z):
            calls.append(1)
            F = residual(z)
            return torch.dot(F, F)

        fnorm = torch.linalg.norm(residual(x))
        xn, ok = _fused_linesearch("bt", residual, fsq, x, dx, fnorm, 1.0)
        assert bool(ok)
        assert float(torch.linalg.norm(residual(xn))) < float(fnorm)
        assert 1 <= len(calls) <= (1 if x.abs().max() == 0 else 5), \
            len(calls)
