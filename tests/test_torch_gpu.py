"""Tests of the port's CUDA kernel; they need a card and skip without
one. This file imports no jax, so on a machine with a card and without
jax it runs alone, without the suite's conftest:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
from proximalgalerkin_torch.ops import mg, mgfused

from chip_smoke import grids_on

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the MG-PCG kernel is CUDA only")
    return torch.device("cuda")


def _rel(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


# 12: one level, all in the one-block coarse kernel; 67 (levels 67, 34)
# and 100 (one level): the coarsest level is too large for one block and
# takes the grid-kernel sweeps
@pytest.mark.parametrize("m", [12, 33, 65, 67, 100, 257])
def test_kernel_matches_plain(cuda, m):
    alpha, b, B, C, whier = grids_on(cuda, m, 0)
    assert _rel(mgfused.kernel_matvec(b, B, C, alpha),
                mgfused.matvec_reference(b, B, C, alpha)) <= 1e-6
    if len(whier) > 1:
        assert _rel(mgfused.kernel_restrict(b), mg.restrict(b)) <= 1e-6
        e = whier[1] / whier[1].abs().max()
        assert _rel(mgfused.kernel_prolong_add(e, b.clone()),
                    b + mg.prolong(e)) <= 1e-6
    assert _rel(mgfused.kernel_pc(b, B, whier, alpha),
                mgfused.pc_reference(b, B, whier, alpha)) <= 1e-5
    before = mgfused.solve.launches
    xk, ik = mgfused.solve(b, B, C, whier, alpha, 1e-6, 500)
    assert mgfused.solve.launches > before
    xp, ip = mgfused.fused_mg_pcg_reference(b, B, C, whier, alpha, 1e-6,
                                            500)
    assert abs(ik - ip) <= 3
    assert float(torch.linalg.norm(xk - xp)) <= 1e-4 * float(
        torch.linalg.norm(xp))
    x5, i5 = mgfused.solve(b, B, C, whier, alpha, 1e-6, 500, chunk=5)
    assert i5 == ik and torch.equal(x5, xk)
    x0, i0 = mgfused.solve(torch.zeros_like(b), B, C, whier, alpha, 1e-6,
                           500)
    assert i0 == 0 and float(x0.abs().max()) == 0.0
    _, i7 = mgfused.solve(b, B, C, whier, alpha, 1e-30, 7, chunk=3)
    assert i7 == 7


def test_kernel_rejects_bad_inputs(cuda):
    alpha, b, B, C, whier = grids_on(cuda, 33, 0)
    with pytest.raises(TypeError):
        mgfused.solve(b, B.double(), C, whier, alpha, 1e-6, 10)
    with pytest.raises(ValueError):
        mgfused.solve(b, B, C.cpu(), whier, alpha, 1e-6, 10)
    with pytest.raises(ValueError):
        mgfused.kernel_prolong_add(whier[1], b[:-1].contiguous())


def test_solver_on_card_matches_cpu(cuda):
    """Mixed + mg at 32^2: the kernel on the card and the plain version
    on the CPU take the same Newton trajectory (the reference's own
    fused-vs-plain bound, atol 5e-9)."""
    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    kw = dict(alpha_cap=1e2, outer_tol=1e-8, mixed_precision=True, pc="mg")
    before = mgfused.solve.launches
    r_c = P1ObstacleSolver(mesh, device=cuda, **kw).solve(max_outer=6)
    assert mgfused.solve.launches > before
    r_h = P1ObstacleSolver(mesh, device="cpu", **kw).solve(max_outer=6)
    assert r_c.newton_per_outer == r_h.newton_per_outer
    assert np.allclose(r_c.u, r_h.u, atol=5e-9)
