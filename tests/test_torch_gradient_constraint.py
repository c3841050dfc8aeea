"""The port's gradient-constraint model (models/gradient_constraint.py)
against the reference's, on the CPU, at the reference test's sizes: the
16^2 P2 / P1-vector solve, the 8^2 Poisson warm start and the 8^2 P1 /
DG0-vector latent (outer and per-step Newton counts identical, u and psi
within 1e-8 relative, the DG0 active set equal), the reference test's
constraint check on the port's solution, and the gradient-constraint
CLI with --opt."""

import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.models.gradient_constraint import \
    solve_gradient_constraint as ref_solve

from proximalgalerkin_torch.models.gradient_constraint import (
    default_phi, solve_gradient_constraint)

CASES = {
    "p2_16": dict(N=16, M=16, primal_degree=2, max_iterations=25,
                  stopping_tol=1e-8, verbose=False, quadrature_degree=6),
    "warm_start_8": dict(N=8, M=8, primal_degree=2, max_iterations=25,
                         warm_start=True, stopping_tol=1e-6, verbose=False,
                         quadrature_degree=4),
    "p1_dg0_8": dict(N=8, M=8, primal_degree=1, max_iterations=30,
                     stopping_tol=1e-6, verbose=False, quadrature_degree=4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    return {name: (solve_gradient_constraint(device="cpu", **kw),
                   ref_solve(**kw))
            for name, kw in CASES.items()}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("case", list(CASES))
def test_matches_reference(solved, case):
    (prob, res), (rprob, rres) = solved[case]
    assert res.converged and rres.converged
    assert res.iterations == rres.iterations
    assert res.newton_steps == rres.newton_steps
    # psi grows like the inverse of the constraint's slack (|psi| ~ 1e6
    # at 16^2), so each field is held relative to its own size
    assert _rel(prob.u(res), rprob.u(rres)) <= 1e-8
    assert _rel(prob.psi(res), rprob.psi(rres)) <= 1e-8
    np.testing.assert_array_equal(prob.active_set_dg0(res),
                                  rprob.active_set_dg0(rres))
    assert prob.Q.element.discontinuous == (case == "p1_dg0_8")


def test_constraint_mostly_satisfied(solved):
    """tests/test_gradient_constraint.py:25-38 on the port's solution:
    the mean positive violation of |grad u| <= phi is small."""
    (prob, res), _ = solved["p2_16"]
    assert res.iterations <= 25 and 10 < res.total_newton < 120
    form = prob.form
    _, grads = form._eval_field("u", res.x, form.cell_data)
    gn = np.linalg.norm(grads[:, :, 0, :].numpy(), axis=-1)
    xq = form.xq.numpy()
    phi_q = default_phi(xq.reshape(-1, 2).T).reshape(gn.shape)
    assert np.maximum(gn - phi_q, 0.0).mean() < 0.01
    u = prob.u(res)
    assert 0 < u.max() < 1.0


def test_cli_gradient_constraint(capsys):
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_tpu.cli import main as ref_main
    argv = ["--opt", "snes_linesearch_type=bt", "--opt", "snes_max_it=30",
            "gradient-constraint", "-N", "4", "-M", "4", "--warm_start",
            "-s", "1e-6"]
    ref_main(argv)
    ref_lines = capsys.readouterr().out.strip().splitlines()
    main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2:] == ref_lines[-2:]
    assert lines[-2].startswith("Number of LVPP iterations ")
