"""The port's DIA SpMV (ops/dia_spmv.py) and fused DIA-CG (ops/dia_cg.py)
on the CPU, where they take their plain PyTorch versions, held against
the reference's Pallas kernels in interpret mode (the goldens of
tests/test_pallas_ops.py) and its assembled operators. The CUDA kernels
themselves run only on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.mesh import rectangle_mesh as ref_rectangle_mesh
from proximalgalerkin_tpu.models.obstacle_p1 import \
    P1ObstacleSolver as RefSolver
from proximalgalerkin_tpu.ops import dia_spmv_pallas
from proximalgalerkin_tpu.ops.pallas_cg import make_fused_dia_cg

from proximalgalerkin_torch.la.dia import DiaMatrix
from proximalgalerkin_torch.models.obstacle_p1 import effective_dia
from proximalgalerkin_torch.ops import dia_cg
from proximalgalerkin_torch.ops.dia_spmv import dia_spmv, dia_spmv_reference

from chip_smoke import spd_dia_system

f32, f64 = torch.float32, torch.float64


def _ref_operator(nx, ny):
    s = RefSolver(ref_rectangle_mesh(nx, ny, p0=(-1, -1), p1=(1, 1)))
    assert s.dia is not None
    return s.dia.offsets, np.array(s.dia.data), s.N


def test_spmv_matches_pallas_golden_f64():
    """tests/test_pallas_ops.py:12: 24^2, f64, within 1e-12."""
    offsets, data, n = _ref_operator(24, 24)
    x = np.random.default_rng(0).normal(size=n)
    y_pl = np.asarray(dia_spmv_pallas(offsets, jnp.asarray(data),
                                      jnp.asarray(x), block=256,
                                      interpret=True))
    y = dia_spmv(offsets, torch.as_tensor(data), torch.as_tensor(x))
    assert y.dtype == f64
    assert np.abs(y.numpy() - y_pl).max() <= 1e-12


def test_spmv_matches_pallas_golden_f32_blocks():
    """tests/test_pallas_ops.py:24: 17x13, f32, blocks of uneven size;
    within 1e-6 relative."""
    offsets, data, n = _ref_operator(17, 13)
    d32 = data.astype(np.float32)
    x = np.random.default_rng(1).normal(size=n).astype(np.float32)
    y_pl = np.asarray(dia_spmv_pallas(offsets, jnp.asarray(d32),
                                      jnp.asarray(x), block=64,
                                      interpret=True))
    y = dia_spmv(offsets, torch.as_tensor(d32), torch.as_tensor(x))
    assert y.dtype == f32
    assert np.abs(y.numpy() - y_pl).max() <= 1e-6 * np.abs(y_pl).max()


def test_dia_matrix_spmv_is_the_op():
    offsets, data, n = _ref_operator(12, 9)
    A = DiaMatrix(offsets=offsets, data=torch.as_tensor(data), n=n)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=n))
    assert torch.equal(A.spmv(x), dia_spmv_reference(offsets, A.data, x))
    d32, x32 = A.data.to(f32), x.to(f32)
    assert torch.equal(A.spmv(x32, d32),
                       dia_spmv_reference(offsets, d32, x32))


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "vector",
                                 "device", "layout", "diagonals"])
def test_spmv_rejects_bad_inputs(bad):
    offsets, data, n = _ref_operator(8, 8)
    d = torch.as_tensor(data)
    x = torch.ones(n, dtype=f64)
    if bad == "dtype":
        d, x = d.to(torch.float16), x.to(torch.float16)
    elif bad == "mixed":
        d = d.to(f32)
    elif bad == "shape":
        d = d[:, :-1]
    elif bad == "vector":
        x = x.reshape(1, n)
    elif bad == "device":
        d = d.to("meta")
    elif bad == "layout":
        d = torch.as_tensor(np.asfortranarray(data))
    else:
        offsets = ()
    with pytest.raises((TypeError, ValueError)):
        dia_spmv(offsets, d, x)


def test_plain_fused_cg_matches_pallas_golden():
    """tests/test_pallas_ops.py:36: the random SPD 7-diagonal system, f64:
    the plain version and the reference's interpret-mode kernels both
    within 1e-9 of the dense solve, in the same number of iterations."""
    offsets, data, b, x_ref = spd_dia_system(800, 25, seed=0)
    x, its = dia_cg.solve(offsets, torch.as_tensor(data),
                          torch.as_tensor(b), 1e-12, 500)
    fused = make_fused_dia_cg(offsets, 800, dtype=jnp.float64,
                              interpret=True)
    xr, itr = fused(jnp.asarray(data), jnp.asarray(b), 1e-12, 500)
    xn = np.linalg.norm(x_ref)
    assert np.linalg.norm(x.numpy() - x_ref) < 1e-9 * xn
    assert np.linalg.norm(np.asarray(xr) - x_ref) < 1e-9 * xn
    assert 0 < its < 100
    assert its == int(itr)


def _cg_system(seed=0):
    offsets, data, b, _ = spd_dia_system(800, 25, seed=seed)
    return offsets, torch.as_tensor(data, dtype=f32), torch.as_tensor(
        b, dtype=f32)


def test_chunk_boundaries_do_not_change_result():
    offsets, data, b = _cg_system(3)
    x64, i64 = dia_cg.solve(offsets, data, b, 1e-6, 500, chunk=64)
    x1, i1 = dia_cg.solve(offsets, data, b, 1e-6, 500, chunk=1)
    x7, i7 = dia_cg.solve(offsets, data, b, 1e-6, 500, chunk=7)
    assert i64 == i1 == i7 > 0
    assert torch.equal(x64, x1) and torch.equal(x64, x7)


def test_maxiter_is_respected():
    offsets, data, b = _cg_system(1)
    _, its = dia_cg.solve(offsets, data, b, 1e-30, maxiter=7, chunk=3,
                          stall_guard=0.0)
    assert its == 7
    _, its0 = dia_cg.solve(offsets, data, b, 1e-6, maxiter=0)
    assert its0 == 0


def test_zero_rhs_returns_zero_after_no_iterations():
    offsets, data, b = _cg_system()
    x, its = dia_cg.solve(offsets, data, torch.zeros_like(b), 1e-6, 500)
    assert its == 0
    assert float(x.abs().max()) == 0.0


def test_stall_exit_returns_the_best_iterate():
    """An unreachable f32 tolerance: the stall exit fires before maxiter
    and the returned iterate has the smallest residual seen."""
    offsets, data, b = _cg_system(2)
    x, its = dia_cg.solve(offsets, data, b, 1e-12, 5000)
    assert 0 < its < 5000
    r = b - dia_spmv_reference(offsets, data, x)
    assert float(torch.linalg.norm(r)) < 1e-5 * float(torch.linalg.norm(b))


def test_ordered_sum_and_pieces():
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.normal(size=300_000))
    assert abs(float(dia_cg.ordered_sum(v)) - float(v.sum())) < 1e-9
    offsets, data, b = _cg_system()
    p = torch.as_tensor(rng.normal(size=800), dtype=f32)
    pn, Ap, part = dia_cg.k1_reference(offsets, data, b, p, 0.5)
    assert torch.equal(pn, b + 0.5 * p)
    assert torch.equal(Ap, dia_spmv_reference(offsets, data, pn))
    assert part.shape == (4,)
    x, r, part = dia_cg.k2_reference(p, b, pn, Ap, 0.25)
    assert torch.equal(r, b - 0.25 * Ap) and part.shape == (4,)


def test_effective_dia_matches_numpy_rebuild():
    """effective_dia against a numpy rebuild of the reference's data_eff
    (models/obstacle_p1.py:576-597) on a seeded state: exact."""
    offsets, data, n = _ref_operator(16, 16)
    rng = np.random.default_rng(5)
    A32 = data.astype(np.float32)
    free = rng.random(n) < 0.7
    sqinv32 = (1.0 / np.sqrt(1.0 + 100.0 * rng.random(n))).astype(
        np.float32)
    m2d32 = np.where(free, 10.0 ** rng.uniform(-2, 8, n), 0.0).astype(
        np.float32)
    alpha32 = np.float32(37.25)

    fs = np.where(free, sqinv32, np.float32(0.0))
    rows = []
    for k, off in enumerate(offsets):
        sh = np.zeros_like(fs)
        if off >= 0:
            sh[:n - off] = fs[off:]
        else:
            sh[-off:] = fs[:n + off]
        row = fs * alpha32 * A32[k] * sh
        if off == 0:
            row = (row + m2d32 * sqinv32 * sqinv32
                   + np.where(free, 0.0, 1.0).astype(np.float32)
                   * sqinv32 * sqinv32)
        rows.append(row)
    want = np.stack(rows)

    got = effective_dia(offsets, torch.as_tensor(A32), torch.as_tensor(free),
                        torch.as_tensor(sqinv32), torch.as_tensor(m2d32),
                        float(alpha32))
    assert got.dtype == f32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "chunk"])
def test_solve_rejects_bad_inputs(bad):
    offsets, data, b = _cg_system()
    chunk = 64
    if bad == "dtype":
        data = data.double()
    elif bad == "shape":
        b = b[:-1]
    elif bad == "device":
        data = data.to("meta")
    else:
        chunk = 0
    with pytest.raises((TypeError, ValueError)):
        dia_cg.solve(offsets, data, b, 1e-6, 10, chunk=chunk)


def test_kernel_entry_points_refuse_cpu_tensors():
    offsets, data, b = _cg_system()
    with pytest.raises(ValueError, match="CUDA"):
        dia_cg.kernel_k1(offsets, data, b, b, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        dia_cg.kernel_k2(b, b, b, b, 0.5)
