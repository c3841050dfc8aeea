"""The port's eigenvalue-constrained Q-tensor model
(models/eigenvalue_constraints.py) against the reference's, on the CPU:
the reference test's solve (10^2 quadrilaterals, P2, quadrature degree 8,
tol 1e-8) with LVPP/Newton counts and the alpha trajectory identical and
q within 1e-8 relative; the residual, element matrices and Jacobian
diagonal of the P3 form at quadrature degree 20 (121 points a cell, the
energy's gradient taken by torch.func.grad inside the residual and
differentiated again by the form's jacfwd) on a handful of cells; a
checkpoint the reference writes after two LVPP steps, resumed by the
port; and the eigenvalue CLI."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import proximalgalerkin_tpu.models.eigenvalue_constraints as ref_mod

import proximalgalerkin_torch.models.eigenvalue_constraints as mod

KW = dict(N=10, degree=2, quadrature_degree=8, tol=1e-8, verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    return (mod.solve_eigenvalue_constraints(device="cpu", **KW),
            ref_mod.solve_eigenvalue_constraints(**KW))


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_counts_and_fields_match_reference(solved):
    res, ref = solved
    assert res.lvpp.converged and ref.lvpp.converged
    assert res.lvpp.iterations == ref.lvpp.iterations
    assert res.lvpp.newton_steps == ref.lvpp.newton_steps
    assert res.lvpp.step_sizes == ref.lvpp.step_sizes
    assert _rel(res.q1, ref.q1) <= 1e-8 and _rel(res.q2, ref.q2) <= 1e-8
    assert _rel(res.lvpp.increments, ref.lvpp.increments) <= 1e-8
    # the reference test's bounds (tests/test_eigenvalue_constraints.py:16)
    assert res.lvpp.iterations < 40 and res.lvpp.total_newton < 150


def test_eigenvalues_bounded(solved):
    """The tanh latent map enforces |lambda(Q)| <= 1/2 at dofs; the
    boundary data saturates the bound."""
    lo, hi = solved[0].eigenvalue_range()
    assert hi <= 0.5 + 1e-8 and lo >= -0.5 - 1e-8
    assert hi > 0.45


class _Captured(Exception):
    pass


def _capture_problem(module, monkeypatch, **kw):
    """The model's NonlinearProblem, caught where the model hands it to
    its LVPPSolver."""
    def stop(problem, *a, **k):
        raise _Captured(problem)
    monkeypatch.setattr(module, "LVPPSolver", stop)
    with pytest.raises(_Captured) as info:
        module.solve_eigenvalue_constraints(**kw)
    return info.value.args[0]


def test_p3_form_matches_reference(monkeypatch):
    """P3 quadrilaterals at quadrature degree 20 on 2^2 cells, at a random
    state and random previous iterates: residual, element matrices and
    Jacobian diagonal within 1e-12 relative of the reference's."""
    kw = dict(N=2, degree=3, quadrature_degree=20, verbose=False)
    pt = _capture_problem(mod, monkeypatch, device="cpu", **kw)
    pr = _capture_problem(ref_mod, monkeypatch, **kw)
    assert pt.form.nq == pr.form.nq == 121
    rng = np.random.default_rng(7)
    n = pt.space.num_dofs
    nv = pt.space.spaces["q1"].num_dofs
    x = 0.3 * rng.standard_normal(n)
    coeffs = {k: 0.3 * rng.standard_normal(nv)
              for k in ("psi1_i", "psi2_i", "q1_i", "q2_i")}
    ct = {k: torch.as_tensor(v) for k, v in coeffs.items()}
    cr = {k: jnp.asarray(v) for k, v in coeffs.items()}
    kt = {"alpha": torch.tensor(1.7, dtype=torch.float64)}
    kr = {"alpha": jnp.asarray(1.7)}
    xt, xr = torch.as_tensor(x), jnp.asarray(x)
    assert _rel(pt.form.residual(xt, ct, kt),
                pr.form.residual(xr, cr, kr)) <= 1e-12
    Ae = pt.form.element_matrices(xt, ct, kt).numpy()
    assert Ae.shape == (4, 64, 64)
    assert _rel(Ae, pr.form.element_matrices(xr, cr, kr)) <= 1e-12
    assert _rel(pt.form.jacobian_diagonal(xt, ct, kt),
                pr.form.jacobian_diagonal(xr, cr, kr)) <= 1e-12
    v = rng.standard_normal(n)
    assert _rel(pt.form.jacobian_action(xt, torch.as_tensor(v), ct, kt),
                pr.form.jacobian_action(xr, jnp.asarray(v), cr, kr)) <= 1e-12


def test_checkpoint_from_reference_resumes_in_port(tmp_path, solved):
    """The reference stops after 2 LVPP steps with its checkpoint on disk;
    the port resumes it and ends with the uninterrupted run's counts."""
    from proximalgalerkin_tpu.core.reasons import NotConvergedError
    res, ref = solved
    ck = str(tmp_path / "ck.npz")
    try:
        ref_mod.solve_eigenvalue_constraints(max_lvpp=2, checkpoint_path=ck,
                                             **KW)
    except (RuntimeError, NotConvergedError):
        pass
    r = mod.solve_eigenvalue_constraints(checkpoint_path=ck, device="cpu",
                                         **KW)
    assert r.lvpp.converged
    assert r.lvpp.iterations == ref.lvpp.iterations
    assert r.lvpp.newton_steps == ref.lvpp.newton_steps
    assert r.lvpp.total_newton == ref.lvpp.total_newton
    assert _rel(r.q1, ref.q1) <= 1e-8


def test_cli_eigenvalue(capsys):
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_tpu.cli import main as ref_main
    argv = ["--opt", "snes_rtol=1e-9", "eigenvalue", "-N", "3", "--degree",
            "2"]
    ref_main(argv)
    ref_last = capsys.readouterr().out.strip().splitlines()[-1]
    main(argv + ["--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == ref_last and last.startswith("#LVPP ")
