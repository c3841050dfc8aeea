"""The port's thermoforming QVI (models/thermoforming.py) against the
reference's, on the CPU, at the reference test's size (M = 24, tol
1e-7): LVPP and per-step Newton counts identical, u, T and psi within
1e-8 relative, the reference test's physical checks on the port's
solution; the clip and max derivatives at their ties against jax.grad
(they move Newton counts); and the thermoforming CLI with --opt."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from proximalgalerkin_tpu.models.thermoforming import \
    solve_thermoforming as ref_solve

from proximalgalerkin_torch.models.thermoforming import (clip, mollifier,
                                                         solve_thermoforming)
from proximalgalerkin_torch.models.thermoforming_compare import _pos

KW = dict(M=24, verbose=False, termination_tol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    return solve_thermoforming(device="cpu", **KW), ref_solve(**KW)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_counts_and_fields_match_reference(solved):
    res, ref = solved
    assert res.converged and ref.converged
    assert res.lvpp_iterations == ref.lvpp_iterations
    assert res.newton_iterations == ref.newton_iterations
    for name in ("u", "T", "psi", "mould"):
        assert _rel(getattr(res, name), getattr(ref, name)) <= 1e-8, name
    # the reference test's bounds (tests/test_thermoforming.py:14)
    assert res.lvpp_iterations < 30 and 10 < res.total_newton < 150


def test_physical_properties(solved):
    """tests/test_thermoforming.py:20-34 on the port's solution: the
    membrane stays below the mould, the temperature is physical, and
    contact occurs."""
    res, _ = solved
    assert float((res.u - res.mould).max()) < 0.02
    assert 0.0 < res.T.min() and res.T.max() < 25.0
    assert float((res.mould - res.u).min()) < 0.02


@pytest.mark.parametrize("s", [-1.0, 0.0, 0.25, 1.0, 2.0])
def test_tie_derivatives_match_jax(s):
    """clip and max(., 0) differentiate as jnp.clip and jnp.maximum do,
    1/2 at a tie (torch.clamp gives 1 and torch.relu 0 there)."""
    t = torch.tensor(s, dtype=torch.float64)
    d = lambda f: float(torch.func.grad(f)(t))
    assert d(lambda z: clip(z, 0.0, 1.0)) == float(
        jax.grad(lambda z: jnp.clip(z, 0.0, 1.0))(s))
    assert d(_pos) == float(jax.grad(lambda z: jnp.maximum(z, 0.0))(s))
    assert d(lambda z: mollifier(z, 0.5)) == float(
        jax.grad(lambda z: jnp.clip(1.0 - z / 0.5, 0.0, 1.0))(s))


def test_cli_thermoforming(capsys):
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_tpu.cli import main as ref_main
    argv = ["--opt", "snes_max_it=40", "thermoforming", "-M", "6",
            "--compare"]
    ref_main(argv)
    ref_lines = capsys.readouterr().out.strip().splitlines()
    main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-4:] == ref_lines[-4:]
    assert lines[-4].startswith("Total LVPP ")
