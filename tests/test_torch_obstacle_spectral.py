"""The port's spectral (Zernike) obstacle solver
(models/obstacle_spectral.py) against the reference's, on the CPU: the
degree sweep at p = 8, 12, 16 (Newton counts identical, sup-differences
within 1e-8 relative), f32_refine walking the f64 trajectory in both
packages, the FEM comparison at p = 14 (the coefficient vector within
1e-8 relative of the reference's), and the obstacle-spectral CLI."""

import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.models.obstacle_spectral import (
    spectral_obstacle_solve as ref_solve, spectral_p_sweep as ref_sweep)

from proximalgalerkin_torch.models.obstacle_spectral import (
    spectral_obstacle_solve, spectral_p_sweep)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sup_close(a, b, rtol=1e-8):
    for x, y in zip(a, b):
        if np.isnan(x) or np.isnan(y):
            assert np.isnan(x) and np.isnan(y)
        else:
            assert abs(x - y) <= rtol * abs(y), (x, y)


def test_sweep_matches_reference():
    res = spectral_p_sweep(ps=(8, 12, 16), device="cpu")
    ref = ref_sweep(ps=(8, 12, 16))
    assert res.degrees == [8, 12, 16]
    assert res.newton_its == ref.newton_its
    _sup_close(res.sup_errors, ref.sup_errors)
    # the reference test's own checks (tests/test_obstacle_spectral.py:10)
    assert res.newton_its[0] > 5
    assert res.sup_errors[2] < res.sup_errors[1]
    assert set(res.phases[0]) == {"tabulate_s", "operators_s", "solve_s"}


def test_f32_refine_matches_f64_counts():
    """f32 LU with three f64 refinement passes walks the f64 Newton
    trajectory, in the port as in the reference."""
    r64 = spectral_p_sweep(ps=(8, 12), device="cpu")
    r32 = spectral_p_sweep(ps=(8, 12), solve_dtype="f32_refine",
                           device="cpu")
    ref32 = ref_sweep(ps=(8, 12), solve_dtype="f32_refine")
    assert r32.newton_its == r64.newton_its == ref32.newton_its
    _sup_close(r32.sup_errors, ref32.sup_errors)
    for a, b in zip(r32.sup_errors, r64.sup_errors):
        if not (np.isnan(a) and np.isnan(b)):
            assert abs(a - b) < 1e-8
    with pytest.raises(ValueError):
        spectral_obstacle_solve(4, solve_dtype="bf16", device="cpu")


def test_matches_fem_on_disk():
    """p = 14 against the reference's coefficients and against the port's
    P1 FEM solve on the disk (the reference's bound 0.08 at r < 0.9)."""
    cu, its, ev = spectral_obstacle_solve(14, device="cpu")
    cu_r, its_r, _ = ref_solve(14)
    assert its == its_r
    assert np.abs(cu - cu_r).max() <= 1e-8 * np.abs(cu_r).max()
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
    s = P1ObstacleSolver(create_disk_mesh(0.07), device="cpu")
    r1 = s.solve()
    pts = s.V.dof_points
    rr = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    tt = np.arctan2(pts[:, 1], pts[:, 0])
    sel = rr < 0.9
    assert np.abs(ev(rr[sel], tt[sel]) - r1.u[sel]).max() < 0.08


def test_cli_obstacle_spectral(capsys):
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_tpu.cli import main as ref_main
    argv = ["obstacle-spectral", "--degrees", "4", "6", "--solve-dtype",
            "f32_refine"]
    ref_main(argv)
    ref_lines = capsys.readouterr().out.strip().splitlines()
    main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(ref_lines)
    # the progress lines and the counts print alike; the sup diffs agree
    # to 1e-8 relative
    assert lines[:-1] == ref_lines[:-1]
    parse = lambda s: [float(v) for v in
                       s.split(":", 1)[1].strip(" []").split(",")]
    _sup_close(parse(lines[-1]), parse(ref_lines[-1]))
