"""The port's bench subcommand on the CPU at small sizes: `--mode fd`
prints the keys of the reference bench's FD worker (bench.py _worker_fd)
with counts equal to the JAX package's fd_obstacle_solve, its stream
worker the three keys of the reference's, at small buffers, and its fem
worker warms up before its timed solve (bench.py _worker_fem), which
keeps the counts and bits of a solve with no warm-up."""

import json

import pytest
import torch

from proximalgalerkin_tpu.models.obstacle_fd import \
    fd_obstacle_solve as ref_fd_obstacle_solve

from proximalgalerkin_torch import cli
from proximalgalerkin_torch.cli import main
from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver

FD_KEYS = {"mode", "elapsed", "n", "dofs", "newton", "outer", "converged",
           "feasibility"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("n", [16, 32])
def test_fd_mode(capsys, n):
    main(["bench", "--mode", "fd", "-n", str(n), "--device", "cpu"])
    out = _json_line(capsys)
    assert FD_KEYS <= set(out)
    assert set(out) - FD_KEYS == {"warmup_s"}
    ref = ref_fd_obstacle_solve(n + 1, outer_tol=1e-8)
    assert out["mode"] == "fd_stencil"
    assert (out["n"], out["dofs"]) == (n, 2 * (n + 1) ** 2)
    assert (out["outer"], out["newton"]) == (ref.outer_iterations,
                                             ref.newton_its)
    assert out["converged"] is True
    assert abs(out["feasibility"] - float((ref.u - ref.phi).min())) <= 1e-10
    assert out["elapsed"] > 0 and out["warmup_s"] > 0


@pytest.mark.parametrize("esz", [4, 8])
def test_stream_mode(esz):
    out = cli.run_bench_stream(65 ** 2, "cpu", esz, gb=(0.002, 0.001))
    assert set(out) == {"stream_gbps", "stream_gbps_dep",
                        "stream_gbps_indep"}
    assert out["stream_gbps"] == max(out["stream_gbps_dep"],
                                     out["stream_gbps_indep"])
    assert all(v > 0 for v in out.values())


def test_stream_mode_cli(capsys, monkeypatch):
    """`bench --mode stream` runs the worker at the reference's buffer
    sizes (1.0 and 0.6 GB, run_bench_stream's default) and prints its
    dict."""
    seen = []

    def fake(n_elems, device, esz=4, gb=(1.0, 0.6)):
        seen.append((n_elems, device, esz, gb))
        return {"stream_gbps": 2.0, "stream_gbps_dep": 1.0,
                "stream_gbps_indep": 2.0}

    monkeypatch.setattr(cli, "run_bench_stream", fake)
    main(["bench", "--mode", "stream", "-n", "64", "--esz", "8",
          "--device", "cpu"])
    assert seen == [(65 ** 2, "cpu", 8, (1.0, 0.6))]
    assert _json_line(capsys) == fake(0, "cpu")


FEM_KEYS = {"mode", "elapsed", "n", "dofs", "newton", "outer", "converged",
            "feasibility", "cg_its", "membw_gbps", "esz", "setup_s",
            "warmup_s"}


def test_fem_mode_warms_up(capsys, monkeypatch):
    """`bench --pc jacobi` (the fem worker) at n = 16 prints setup_s and
    warmup_s beside the existing keys; its timed solve, after the warm-up
    Newton solve, has the counts and the bits of u of a solve with no
    warm-up, and a second call in the same process does too. (On the
    card, chip_smoke.py's phases 6 and 7 check that the timed 1024^2
    solves capture no chunk graph.)"""
    pc, calls = "jacobi", 2
    real, solves = P1ObstacleSolver.solve, []

    def spy(solver, *args, **kwargs):
        solves.append(real(solver, *args, **kwargs))
        return solves[-1]

    monkeypatch.setattr(P1ObstacleSolver, "solve", spy)
    outs = []
    for _ in range(calls):
        main(["bench", "-n", "16", "--pc", pc, "--device", "cpu"])
        out, err = capsys.readouterr()
        outs.append(json.loads(out.strip().splitlines()[-1]))
        assert "# warmup" in err
    cold = real(P1ObstacleSolver(
        rectangle_mesh(16, 16, p0=(-1.0, -1.0), p1=(1.0, 1.0)),
        alpha_cap=1e2, outer_tol=1e-8, mixed_precision=True, pc=pc,
        device="cpu"))
    assert len(solves) == calls
    for out, res in zip(outs, solves):
        assert set(out) == FEM_KEYS
        assert out["setup_s"] > 0 and out["warmup_s"] > 0
        assert (out["outer"], out["newton"], out["cg_its"]) == (
            cold.outer_iterations, cold.newton_its, cold.cg_its_total)
        assert res.newton_per_outer == cold.newton_per_outer
        assert res.u.tobytes() == cold.u.tobytes()
