"""The port's intersecting-constraints model (models/intersecting.py)
against the reference's, on the CPU, at the reference test's size (201
cells, phi = 3, 1, 0.1): LVPP and Newton counts per continuation step
identical (the adaptive retry machine walks the same alpha trajectory),
u within 1e-8 relative, the reference test's physical checks on the
port's solution, and the intersecting CLI."""

import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.models.intersecting import \
    solve_intersecting as ref_solve

from proximalgalerkin_torch.models.intersecting import (smooth_bump,
                                                        solve_intersecting)

KW = dict(n_cells=201, phis=(3.0, 1.0, 0.1), verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    return solve_intersecting(device="cpu", **KW), ref_solve(**KW)


def test_counts_and_u_match_reference(solved):
    res, ref = solved
    assert res.converged == ref.converged == [True, True, True]
    assert res.lvpp_iterations == ref.lvpp_iterations
    assert res.newton_iterations == ref.newton_iterations
    assert res.phis == ref.phis
    assert np.abs(res.u - ref.u).max() <= 1e-8 * np.abs(ref.u).max()


def test_continuation_converges(solved):
    res, _ = solved
    assert all(res.converged)
    assert all(1 <= n <= 60 for n in res.lvpp_iterations)


def test_obstacle_and_gradient_bounds(solved):
    """tests/test_intersecting.py:22-41 on the port's solution: u above
    the bump, |u'| <= 0.1 outside the window, pinned near x = 0.2."""
    res, _ = solved
    xs = np.linspace(0, 1, 202)
    assert float((res.u - smooth_bump(xs)).min()) > -1e-3
    du = np.diff(res.u) / (xs[1] - xs[0])
    mask = (xs[:-1] < 0.19) | (xs[:-1] > 0.81)
    assert float(np.abs(du[mask]).max()) < 0.105
    at_02 = res.u[np.argmin(np.abs(xs - 0.2))]
    assert at_02 < 0.25 * smooth_bump(np.array([0.5]))[0] + 0.05


def test_cli_intersecting(capsys):
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_tpu.cli import main as ref_main
    ref_main(["intersecting", "--cells", "41"])
    ref_lines = capsys.readouterr().out.strip().splitlines()
    main(["intersecting", "--cells", "41", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2:] == ref_lines[-2:]
    assert lines[-2].startswith("num_lvpp_iterations=[")
