"""The port's DIA and ELL operators (torch) against the reference's (JAX)
on the same assembled P1 stiffness, in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.mesh import rectangle_mesh as ref_rectangle_mesh
from proximalgalerkin_tpu.models.obstacle_p1 import \
    P1ObstacleSolver as RefSolver

from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver

f64 = torch.float64


def _solvers(diagonal, use_dia):
    kw = dict(p0=(-1.0, -1.0), p1=(1.0, 1.0), diagonal=diagonal)
    sr = RefSolver(ref_rectangle_mesh(12, 12, **kw), use_dia=use_dia)
    st = P1ObstacleSolver(rectangle_mesh(12, 12, **kw), use_dia=use_dia,
                          device="cpu")
    return sr, st


@pytest.mark.parametrize("diagonal", ["right", "crossed"])
def test_dia_spmv_matches_reference(diagonal):
    sr, st = _solvers(diagonal, True)
    rng = np.random.default_rng(1)
    for _ in range(3):
        x = rng.normal(size=st.N)
        y_ref = np.asarray(sr.dia.spmv(jnp.asarray(x)))
        y = st.dia.spmv(torch.as_tensor(x, dtype=f64)).numpy()
        np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(st.dia.diagonal().numpy(),
                                  np.asarray(sr.dia.diagonal()))


@pytest.mark.parametrize("diagonal", ["right", "crossed"])
def test_ell_spmv_matches_reference(diagonal):
    sr, st = _solvers(diagonal, False)
    assert sr.dia is None and st.dia is None
    np.testing.assert_array_equal(st.A_data.numpy(), np.asarray(sr.A_data))
    rng = np.random.default_rng(2)
    for _ in range(3):
        x = rng.normal(size=st.N)
        y_ref = np.asarray(sr.ell.spmv(sr.A_data, jnp.asarray(x)))
        y = st.ell.spmv(st.A_data, torch.as_tensor(x, dtype=f64)).numpy()
        np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(
        st.ell.diagonal(st.A_data).numpy(),
        np.asarray(sr.ell.diagonal(sr.A_data)))


def test_ell_assemble_matches_reference():
    """segment_sum (JAX) and index_add_ (torch) scatter the same element
    matrices into the same ELL data, BC rows applied."""
    sr, st = _solvers("right", False)
    ne = st.V.dofmap.shape[0]
    Ae = np.random.default_rng(3).normal(size=(ne, 3, 3))
    ref = np.asarray(sr.ell.assemble(jnp.asarray(Ae)))
    got = st.ell.assemble(torch.as_tensor(Ae, dtype=f64)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13)


def test_dia_matches_ell_on_crossed_mesh():
    """DIA and ELL storage are the same operator on crossed meshes, with
    no zero stored diagonal (the reference's test_obstacle_p1.py:57)."""
    mesh = rectangle_mesh(12, 12, p0=(-1.0, -1.0), p1=(1.0, 1.0),
                          diagonal="crossed")
    s_dia = P1ObstacleSolver(mesh, device="cpu")
    s_ell = P1ObstacleSolver(mesh, use_dia=False, device="cpu")
    assert s_dia.dia is not None and s_ell.dia is None
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = torch.as_tensor(rng.normal(size=s_dia.N), dtype=f64)
        np.testing.assert_allclose(s_dia.dia.spmv(x).numpy(),
                                   s_ell.ell.spmv(s_ell.A_data, x).numpy(),
                                   rtol=1e-13, atol=1e-13)
    d_dia = s_dia.dia.diagonal().numpy()
    np.testing.assert_allclose(d_dia,
                               s_ell.ell.diagonal(s_ell.A_data).numpy(),
                               rtol=1e-13)
    assert (d_dia != 0.0).all()
