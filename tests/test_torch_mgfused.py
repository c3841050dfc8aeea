"""The port's fused MG-PCG (ops/mgfused.py). On the CPU the solve takes
its plain PyTorch version, held here against the reference: JAX
ops/mg.pcg and the JAX FusedMgCg kernel in Pallas interpret mode, at
m = 33 on the deep-contact Schur state. The CUDA kernel itself runs only
on the card (tests/test_torch_gpu.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.ops import mg as ref_mg
from proximalgalerkin_tpu.ops.mgfused import (FusedMgCg, pad_to_grid,
                                              unpad_from_grid)

from proximalgalerkin_torch.ops import mg, mgfused

from chip_smoke import deep_contact_state, grids_on

M = 33
f32 = torch.float32


def grids(m, seed=0):
    """(alpha, b, B, C, whier) as (m, m) f32 CPU tensors for the port."""
    return grids_on(torch.device("cpu"), m, seed)


def _ref_pcg(m, b, seed=0, tol=1e-6, maxiter=500):
    """The reference's XLA MG-PCG on the same state, as its
    test_mgfused.py drives it."""
    alpha, free, B, C, w0, _, sq = deep_contact_state(m, seed)
    B32, C32 = jnp.asarray(B), jnp.asarray(C)
    free32 = jnp.asarray(free.astype(np.float32))

    def S32t(vt):
        y5 = ref_mg.k5_apply((B32 * vt).reshape(m, m)).reshape(-1)
        return jnp.float32(alpha) * B32 * (free32 * y5) + C32 * vt

    mgpc = ref_mg.make_mg_pc(m)(jnp.asarray(alpha, jnp.float32),
                                jnp.asarray(w0))
    sq32 = jnp.asarray(np.where(free, sq, 1.0), jnp.float32)
    x, its = ref_mg.pcg(S32t, jnp.asarray(b), lambda r:
                        sq32 * free32 * mgpc(sq32 * r), tol, maxiter)
    return np.asarray(x), int(its), S32t


def test_plain_matches_reference_pcg_and_fused_kernel():
    tol, maxiter = 1e-6, 500
    alpha, b, B, C, whier = grids(M)
    xt, itt = mgfused.solve(b, B, C, whier, alpha, tol, maxiter)
    xt = xt.reshape(-1).numpy()
    assert itt > 0

    xr, itr, S32t = _ref_pcg(M, b.reshape(-1).numpy())
    assert abs(itt - itr) <= 3
    assert np.linalg.norm(xt - xr) <= 1e-4 * np.linalg.norm(xr)
    bn = np.linalg.norm(b.numpy())
    assert np.linalg.norm(b.numpy().reshape(-1)
                          - np.asarray(S32t(jnp.asarray(xt)))) < 5 * tol * bn

    # the reference's Pallas kernel in interpret mode (padded grids)
    fu = FusedMgCg(M, chunk=64, interpret=True)
    pad = [pad_to_grid(jnp.asarray(w.reshape(-1).numpy()), w.shape[0])
           for w in whier]
    xf, itf = fu.solve(*(pad_to_grid(jnp.asarray(v.reshape(-1).numpy()), M)
                         for v in (b, B, C)), pad, alpha, tol, maxiter)
    xf = np.asarray(unpad_from_grid(xf, M))
    assert abs(itt - int(itf)) <= 3
    assert np.linalg.norm(xt - xf) <= 1e-4 * np.linalg.norm(xf)


def test_chunk_boundaries_do_not_change_result():
    alpha, b, B, C, whier = grids(M, seed=3)
    x64, i64 = mgfused.solve(b, B, C, whier, alpha, 1e-6, 500, chunk=64)
    x5, i5 = mgfused.solve(b, B, C, whier, alpha, 1e-6, 500, chunk=5)
    assert i64 == i5 > 0
    assert torch.equal(x64, x5)


def test_maxiter_is_respected():
    alpha, b, B, C, whier = grids(M, seed=1)
    _, its = mgfused.solve(b, B, C, whier, alpha, 1e-30, maxiter=7,
                           chunk=3)
    assert its == 7


def test_zero_rhs_returns_zero_after_no_iterations():
    """A zero right-hand side returns at once (the reference's fused
    driver would loop forever here; ops/mg.pcg returns 0 iterations)."""
    alpha, b, B, C, whier = grids(M)
    x, its = mgfused.solve(torch.zeros_like(b), B, C, whier, alpha, 1e-6,
                           500)
    _, itr, _ = _ref_pcg(M, np.zeros(M * M, np.float32))
    assert its == itr == 0
    assert float(x.abs().max()) == 0.0


def test_plain_pieces_match_mg_module():
    alpha, b, B, C, whier = grids(M)
    z = mgfused.pc_reference(b, B, whier, alpha)
    sqf = B * (4.0 * torch.tensor(np.float32(alpha)) + whier[0])
    pc = mg.make_mg_pc(M)(np.float32(alpha), whier[0].reshape(-1))
    assert torch.equal(z.reshape(-1), sqf.reshape(-1)
                       * pc((sqf * b).reshape(-1)))
    Ap = mgfused.matvec_reference(b, B, C, alpha)
    assert Ap.shape == (M, M) and Ap.dtype == f32


@pytest.mark.parametrize("bad", ["dtype", "shape", "levels", "layout"])
def test_solve_rejects_bad_inputs(bad):
    alpha, b, B, C, whier = grids(M)
    if bad == "dtype":
        B = B.double()
    elif bad == "shape":
        C = C[:-1]
    elif bad == "levels":
        whier = whier[:-1]
    else:
        b = b.t()
    with pytest.raises((TypeError, ValueError)):
        mgfused.solve(b, B, C, whier, alpha, 1e-6, 10)


def test_kernel_entry_points_refuse_cpu_tensors():
    alpha, b, B, C, whier = grids(M)
    with pytest.raises(ValueError, match="CUDA"):
        mgfused.kernel_matvec(b, B, C, alpha)
    with pytest.raises(ValueError, match="CUDA"):
        mgfused.kernel_pc(b, B, whier, alpha)
