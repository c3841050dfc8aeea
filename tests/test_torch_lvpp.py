"""The port's general LVPP stack (core/, solve/, utils/checkpoint.py,
models/obstacle.py) against the reference's, on the CPU: the obstacle
problem at 16^2 P1 with the default LU direction (newton_per_outer and
the outer count identical, u within 1e-9, observables within 1e-9
relative, identical CSV headers), the unstructured-disk protocol, the
alpha schedules, the retry machine, line searches, LU options, and a
checkpoint written by the reference's LVPPSolver resumed by the port's."""

import csv
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proximalgalerkin_tpu.core import config as ref_config
from proximalgalerkin_tpu.core.reasons import ConvergedReason as RefReason
from proximalgalerkin_tpu.mesh import rectangle_mesh as ref_rectangle
from proximalgalerkin_tpu.mesh.unstructured import \
    create_disk_mesh as ref_disk
from proximalgalerkin_tpu.models import setup_obstacle_problem as ref_setup
from proximalgalerkin_tpu.solve import AlphaScheduler as RefAlpha
from proximalgalerkin_tpu.utils.checkpoint import \
    LVPPCheckpoint as RefCheckpoint

from proximalgalerkin_torch.core import (ConvergedReason, PhaseTimer,
                                         SolverOptions, rank_print)
from proximalgalerkin_torch.core.logging import process_index
from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
from proximalgalerkin_torch.models.obstacle import (coefficients_on,
                                                    setup_obstacle_problem)
from proximalgalerkin_torch.solve import (AlphaScheduler, NewtonSolver,
                                          SNESSolver)
from proximalgalerkin_torch.utils.checkpoint import LVPPCheckpoint

KW = dict(polynomial_order=1, alpha_scheme="double_exponential",
          alpha_max=1e2, tol_exit=1e-6, verbose=False)
OBSERVABLES = ("Energy", "Complementarity", "Feasibility",
               "Dual Feasibility", "Latent increments")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    torch's thread pool slows many times over when the test workers
    already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _square(n):
    kw = dict(p0=(-1.0, -1.0), p1=(1.0, 1.0))
    return ref_rectangle(n, n, **kw), rectangle_mesh(n, n, **kw)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def square16():
    """Both packages' full LVPP solves at 16^2 P1, default preonly/lu."""
    mr, mt = _square(16)
    pr, pt = ref_setup(mr, **KW), setup_obstacle_problem(mt, device="cpu",
                                                          **KW)
    return pr, pr.solve(), pt, pt.solve()


def test_obstacle_16_matches_reference(square16, tmp_path):
    pr, rr, pt, rt = square16
    assert rt.converged and rr.converged
    assert rt.iterations == rr.iterations
    assert rt.newton_steps == rr.newton_steps
    assert np.abs(pt.u(rt) - pr.u(rr)).max() <= 1e-9
    assert _rel(rt.step_sizes, rr.step_sizes) == 0.0
    assert _rel(rt.increments, rr.increments) <= 1e-9
    for name in OBSERVABLES:
        assert _rel(rt.observables[name], rr.observables[name]) <= 1e-9, name
    extra = {"Polynomial order": 1, "dofs": pt.V.num_scalar_dofs,
             "Step size rule": "double_exponential"}
    rt.to_csv(tmp_path / "t.csv", extra=extra)
    rr.to_csv(tmp_path / "r.csv", extra=extra)
    rows_t = list(csv.reader(open(tmp_path / "t.csv")))
    rows_r = list(csv.reader(open(tmp_path / "r.csv")))
    assert rows_t[0] == rows_r[0] and len(rows_t) == len(rows_r)
    rt.to_jsonl(tmp_path / "t.jsonl", extra=extra)
    rr.to_jsonl(tmp_path / "r.jsonl", extra=extra)
    keys = lambda p: [list(json.loads(ln)) for ln in open(p)]
    assert keys(tmp_path / "t.jsonl") == keys(tmp_path / "r.jsonl")
    # the PhaseTimer of the LU direction
    assert {"residual", "assembly", "host_transfer", "lu_factor",
            "linear_solve_lu", "linesearch"} <= set(pt.solver.timer.totals)


def test_coefficient_converter_and_residual(square16):
    """The reference problem's coefficient dict (phi at the quadrature
    points, psi_k, u_k) moved into the port's problem gives the
    reference's residual."""
    pr, rr, pt, _ = square16
    ref_coeffs = {k: np.asarray(v) for k, v in pr.problem.coeffs.items()}
    coeffs = coefficients_on(ref_coeffs, "cpu")
    np.testing.assert_array_equal(coeffs["phi"].numpy(), ref_coeffs["phi"])
    np.testing.assert_array_equal(pt.problem.coeffs["phi"].numpy(),
                                  ref_coeffs["phi"])
    pt.problem.update(coeffs=coeffs, consts={
        "alpha": torch.tensor(float(pr.problem.consts["alpha"]),
                              dtype=torch.float64)})
    x = np.asarray(rr.x) + 1e-3 * np.random.default_rng(4).standard_normal(
        pt.space.num_dofs)
    F = pt.problem.residual(x).numpy()
    assert _rel(F, pr.problem.residual(jnp.asarray(x))) <= 1e-12


def test_disk_protocol_matches_reference(tmp_path):
    """The reference's canonical run (tests/test_obstacle.py:149):
    create_disk_mesh(0.12), bit-identical to the reference's mesh."""
    mr, mt = ref_disk(0.12), create_disk_mesh(0.12)
    np.testing.assert_array_equal(mt.points, mr.points)
    np.testing.assert_array_equal(mt.cells, mr.cells)
    pr, pt = ref_setup(mr, **KW), setup_obstacle_problem(mt, device="cpu",
                                                          **KW)
    rr, rt = pr.solve(), pt.solve()
    assert rt.converged and 3 <= rt.iterations <= 25
    assert rt.total_newton <= 100
    assert rt.newton_steps == rr.newton_steps
    assert np.abs(pt.u(rt) - pr.u(rr)).max() <= 1e-9
    rt.to_csv(tmp_path / "out.csv", extra={
        "Polynomial order": 1, "dofs": pt.V.num_scalar_dofs,
        "Step size rule": "double_exponential"})
    header = (tmp_path / "out.csv").read_text().splitlines()[0]
    for col in OBSERVABLES + ("Newton steps", "Step sizes",
                              "Primal increments", "Polynomial order",
                              "dofs", "Step size rule"):
        assert col in header, col


@pytest.mark.parametrize("scheme", ["constant", "linear", "doubling",
                                    "geometric", "double_exponential"])
def test_alpha_schedules_match_reference(scheme):
    a = AlphaScheduler(scheme=scheme, C=0.5, r=1.7, q=1.9, c=0.3,
                       alpha_max=1e7)
    b = RefAlpha(scheme=scheme, C=0.5, r=1.7, q=1.9, c=0.3, alpha_max=1e7)
    assert [a.value(k) for k in range(40)] == [b.value(k) for k in range(40)]
    a.reset()
    b.reset()
    assert a.value(0) == b.value(0)
    with pytest.raises(ValueError):
        AlphaScheduler(scheme="nope").value(0)


def test_retry_machine_matches_reference():
    """The adaptive retry machine (halve alpha and roll back on a failed
    Newton solve, grow on fast convergence): snes_max_it = 4 makes the
    first outer steps fail twice; the port walks the reference's alpha
    trajectory and Newton counts."""
    mr, mt = _square(8)
    kw = dict(KW, solver_options={"snes_max_it": 4})
    pr, pt = ref_setup(mr, **kw), setup_obstacle_problem(mt, device="cpu",
                                                         **kw)
    pr.solver.adaptive = pt.solver.adaptive = True
    rr, rt = pr.solve(), pt.solve()
    assert rt.converged and rr.converged
    assert rt.step_sizes == rr.step_sizes and rt.step_sizes[0] == 0.25
    assert rt.newton_steps == rr.newton_steps
    assert np.abs(pt.u(rt) - pr.u(rr)).max() <= 1e-9


def test_failed_newton_aborts_without_commit():
    _, mt = _square(8)
    pt = setup_obstacle_problem(mt, device="cpu",
                                **dict(KW, solver_options={"snes_max_it": 2}))
    res = pt.solve()
    assert not res.converged and res.iterations == 0
    assert float(res.x.abs().max()) == 0.0


def test_checkpoint_from_reference_resumes_in_port(tmp_path):
    """A checkpoint that the reference's LVPPSolver writes after 3 outer
    steps of the 16^2 problem resumes in the port's LVPPSolver: the
    remaining Newton steps and the final u are those of the reference's
    uninterrupted run (the pattern of tests/test_checkpoint.py:11)."""
    mr, mt = _square(16)
    full = ref_setup(mr, **KW).solve()
    part = ref_setup(mr, **dict(KW,
                                maximum_number_of_outer_loop_iterations=3))
    part.solver.checkpoint_path = str(tmp_path / "state.npz")
    res_a = part.solve()
    assert not res_a.converged and res_a.iterations == 3
    state = LVPPCheckpoint.load(tmp_path / "state.npz")
    assert state.iteration == 3
    ref_state = RefCheckpoint.load(tmp_path / "state.npz")
    np.testing.assert_array_equal(state.x_k, ref_state.x_k)

    pt = setup_obstacle_problem(mt, device="cpu", **KW)
    res = pt.solver.solve(pt.space.zeros(), resume=state)
    assert res.converged and res.iterations == full.iterations
    assert res.newton_steps == full.newton_steps
    assert np.abs(pt.u(res) - np.asarray(full.x[:pt.V.num_dofs])).max() \
        <= 1e-9

    # the port writes the same file format, which the reference reads
    pt.solver.checkpoint_path = str(tmp_path / "port.npz")
    pt.solver.max_iterations = 2
    pt.solve()
    back = RefCheckpoint.load(tmp_path / "port.npz")
    assert back.iteration == 2 and back.newton_steps == full.newton_steps[:2]


@pytest.mark.parametrize("opts", [
    {"snes_linesearch_type": "l2"},
    {"snes_linesearch_type": "bt"},
    {"snes_linesearch_type": "bt", "snes_fused": True, "ksp_type": "minres",
     "pc_type": "jacobi", "ksp_rtol": 1e-12},
    {"snes_linesearch_type": "l2", "snes_fused": True, "ksp_type": "cg",
     "pc_type": "jacobi", "ksp_rtol": 1e-12, "snes_fused_chunk": 2},
    {"pc_factor_lag": 1, "pc_factor_ordering": "nd"},
    {"ksp_type": "minres", "pc_type": "jacobi", "ksp_rtol": 1e-12,
     "ksp_chunk_it": 200, "ksp_max_it": 600},
], ids=["l2", "bt", "fused_bt", "fused_l2_chunked", "lu_lag_nd",
        "ksp_chunk_it"])
def test_newton_options_match_reference(opts):
    """One Newton solve of the 8^2 obstacle's first outer step (alpha 1)
    with each line search, the fused loop, lagged nested-dissection LU
    and chunked Krylov: the reference's reason, iteration count and x."""
    from proximalgalerkin_tpu.solve.newton import NewtonSolver as RefNewton
    mr, mt = _square(8)
    pr, pt = ref_setup(mr, **KW), setup_obstacle_problem(mt, device="cpu",
                                                         **KW)
    nv = pt.V.num_dofs
    base = {"snes_rtol": 1e-8, "snes_max_it": 30}
    pr.problem.update(coeffs={"psi_k": jnp.zeros(nv), "u_k": jnp.zeros(nv)})
    pt.problem.update(coeffs=coefficients_on(
        {"psi_k": np.zeros(nv), "u_k": np.zeros(nv)}, "cpu"))
    rr = RefNewton(pr.problem, ref_config.SolverOptions(
        dict(base, **opts))).solve(pr.space.zeros())
    rt = NewtonSolver(pt.problem, SolverOptions(dict(base, **opts))).solve(
        pt.space.zeros())
    assert int(rt.reason) == int(rr.reason) and rt.converged
    assert rt.iterations == rr.iterations
    assert _rel(rt.x.numpy(), np.asarray(rr.x)) <= 1e-9


def test_snes_solver_commits_only_on_convergence():
    _, mt = _square(6)
    pt = setup_obstacle_problem(mt, device="cpu", **KW)
    nv = pt.V.num_dofs
    pt.problem.update(coeffs=coefficients_on(
        {"psi_k": np.zeros(nv), "u_k": np.zeros(nv)}, "cpu"))
    s = SNESSolver(pt.problem, {"snes_max_it": 1})
    reason, its = s.solve()
    assert reason < 0 and float(s.u.abs().max()) == 0.0
    s = SNESSolver(pt.problem, {"snes_max_it": 20})
    reason, its = s.solve()
    assert reason > 0 and its > 1 and float(s.u.abs().max()) > 0.0


def test_core_matches_reference(capsys):
    assert {r.name: int(r) for r in ConvergedReason} == \
        {r.name: int(r) for r in RefReason}
    ours = SolverOptions({"snes_rtol": 1e-3, "snes_monitor": None})
    theirs = ref_config.SolverOptions({"snes_rtol": 1e-3,
                                       "snes_monitor": None})
    for key in list(SolverOptions._DEFAULTS) + ["snes_monitor", "nope"]:
        assert ours.opt(key) == theirs.opt(key), key
    assert SolverOptions.with_prefix({"a_x": 1, "y": 2}, "a_") == \
        ref_config.SolverOptions.with_prefix({"a_x": 1, "y": 2}, "a_")
    assert process_index() == 0
    rank_print("hello")
    assert capsys.readouterr().out == "hello\n"
    timer = PhaseTimer("cpu")
    with timer.phase("a"):
        pass
    with timer.phase("a"):
        pass
    assert timer.counts == {"a": 2} and "a: " in timer.report()


def test_cli_obstacle(tmp_path, capsys):
    from proximalgalerkin_torch.cli import main
    main(["obstacle", "--disk-res", "0.3", "--alpha-scheme",
          "double_exponential", "--alpha-max", "1e2", "--output-dir",
          str(tmp_path), "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("LVPP iterations:")
    assert (tmp_path / "u.vtu").exists()
    (csv_file,) = tmp_path.glob("example_polyorder1_*.csv")
    header = csv_file.read_text().splitlines()[0]
    assert "Step size rule" in header and "Energy" in header
    # the dof-partitioned path over 8 subdomains: the reference CLI's last
    # line (the reference on its 8 virtual devices)
    from proximalgalerkin_tpu.cli import main as ref_main
    argv = ["obstacle", "--disk-res", "0.3", "--alpha-scheme",
            "double_exponential", "--alpha-max", "1e2", "--max-iter", "3",
            "--output-dir", str(tmp_path), "--n-devices", "8"]
    ref_main(argv)
    ref_last = capsys.readouterr().out.strip().splitlines()[-1]
    main(argv + ["--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == ref_last
    assert last.startswith("[distributed x8] LVPP iterations: 3 ")


@pytest.mark.parametrize("mesh", [["--disk-res", "0.3"],
                                  ["--rectangle", "16"]])
def test_cli_obstacle_distributed_btlu(mesh, tmp_path, capsys):
    """`obstacle --n-devices 8 --pc btlu`: restricted additive Schwarz
    with a block-tridiagonal subdomain factor under GMRES(120), whose
    exact-enough directions give the single-device host-LU run's counts
    (the first LVPP step, on the test above's disk and on the 16^2
    rectangle of [-1, 1]^2, the benchmark's distributed mesh cut)."""
    from proximalgalerkin_torch.cli import main
    argv = ["obstacle", *mesh, "--alpha-scheme", "double_exponential",
            "--alpha-max", "1e2", "--max-iter", "1",
            "--output-dir", str(tmp_path), "--device", "cpu"]
    main(argv)
    host = capsys.readouterr().out.strip().splitlines()[-1]
    assert host.startswith("LVPP iterations: 1  Newton total: ")
    main(argv + ["--n-devices", "8", "--pc", "btlu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[distributed x8] " + host + "  converged: ")
