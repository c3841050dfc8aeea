"""The port's FD obstacle solver (models/obstacle_fd.py) against the
reference's (proximalgalerkin_tpu/models/obstacle_fd.py) on the CPU:
newton_per_outer identical and u within 1e-10 at N = 17 and 33, the
resolution sweep's Newton totals identical, and the reference tests'
own checks (tests/test_obstacle_fd.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proximalgalerkin_tpu.models import obstacle_fd as ref
from proximalgalerkin_torch.core.logging import counter
from proximalgalerkin_torch.models import obstacle_fd
from proximalgalerkin_torch.models.obstacle_fd import (
    fd_obstacle_solve, fd_resolution_sweep)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    torch's thread pool slows many times over when the test workers
    already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("N", [17, 33])
def test_matches_reference(N):
    r_ref = ref.fd_obstacle_solve(N)
    before = counter("host_reads")
    r = fd_obstacle_solve(N, device="cpu")
    reads = counter("host_reads") - before
    assert r.newton_per_outer == r_ref.newton_per_outer
    assert r.outer_iterations == r_ref.outer_iterations
    assert np.abs(r.u - r_ref.u).max() <= 1e-10
    np.testing.assert_array_equal(r.phi, r_ref.phi)
    # one read per Newton step (and one to end each Newton loop), one per
    # 64-iteration CG chunk
    newton_reads = r.newton_its + r.outer_iterations
    assert newton_reads < reads <= newton_reads + r.newton_its + \
        r.cg_its // 64


def test_resolution_sweep_matches_reference():
    """Newton totals over N = 2^j + 1, j = 1..5, equal to the reference's
    (the reference package gives [16, 18, 17, 17, 17] with its current
    Jacobi-scaled Schur CG; RESULTS.md's [16, 18, 17, 17, 21, 43] predates
    that change)."""
    js = (1, 2, 3, 4, 5)
    assert fd_resolution_sweep(js, device="cpu") == \
        ref.fd_resolution_sweep(js) == [16, 18, 17, 17, 17]


def test_laplacian_matches_reference_bitwise():
    u = np.random.default_rng(0).standard_normal((9, 9))
    interior = torch.zeros((9, 9), dtype=torch.bool)
    interior[1:-1, 1:-1] = True
    ours = obstacle_fd._laplacian_dirichlet(torch.tensor(u), 64.0, interior)
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(ref._laplacian_dirichlet(jnp.asarray(u),
                                                          64.0)))


def test_converges_and_feasible():
    res = fd_obstacle_solve(33, device="cpu")
    assert res.outer_iterations < 20
    assert res.u[0, :].max() == 0.0 and res.u[-1, :].max() == 0.0
    assert float((res.u - res.phi).min()) > -5e-3
    c = res.u.shape[0] // 2
    assert abs(res.u[c, c] - res.phi[c, c]) < 1e-3


def test_matches_dense_oracle():
    """The Schur-CG solver against a dense numpy Newton solve of the same
    FD system (the reference test's oracle)."""
    N = 9
    res = fd_obstacle_solve(N, device="cpu")
    xs = np.linspace(-1, 1, N)
    h2inv = 1.0 / (xs[1] - xs[0]) ** 2
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    phi = res.phi.ravel()
    n = N * N
    A = np.zeros((n, n))
    idx = np.arange(n).reshape(N, N)
    interior = np.zeros((N, N), bool)
    interior[1:-1, 1:-1] = True
    for i in range(N):
        for j in range(N):
            k = idx[i, j]
            if not interior[i, j]:
                A[k, k] = 1.0
                continue
            A[k, k] = 4 * h2inv
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                A[k, idx[i + di, j + dj]] = -h2inv
    ivec = interior.ravel()
    u, psi, w, up = np.zeros(n), np.ones(n), np.zeros(n), np.zeros(n)
    alpha = 1.0
    for k in range(100):
        alpha = min(max(1.5 ** (1.5**k) - alpha, 1.0), 1e2)
        for it in range(50):
            gu = alpha * (A @ u) + np.where(ivec, psi - w, 0.0)
            gu[~ivec] = u[~ivec]
            gp = np.where(ivec, u - np.exp(psi) - phi, 0.0)
            g = np.concatenate([gu, gp])
            if it == 0:
                n0 = np.linalg.norm(g)
            if np.linalg.norm(g) < 1e-4 * n0 and it > 0:
                break
            J = np.block([[alpha * A, np.diag(ivec.astype(float))],
                          [np.diag(ivec.astype(float)),
                           np.diag(np.where(ivec, -np.exp(psi), 1.0))]])
            dz = np.linalg.solve(J, -g)
            u, psi = u + dz[:n], psi + dz[n:]
        w = psi.copy()
        if np.linalg.norm(u - up) < 1e-9:
            break
        up = u.copy()
    assert np.abs(res.u.ravel() - u).max() < 1e-4


def test_cli_obstacle_fd(capsys):
    from proximalgalerkin_torch.cli import main
    main(["obstacle-fd", "-N", "9", "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    r = fd_obstacle_solve(9, device="cpu")
    assert last == f"outer {r.outer_iterations} newton {r.newton_its}"
