"""The port's lattice multigrid (ops/mg.py, torch f32) against the
reference's (JAX) at m = 33, on the deep-contact Schur state of the
reference's fused MG-PCG tests (diagonal jumps of 1e10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.ops import mg as ref_mg

from proximalgalerkin_torch.ops import mg

from chip_smoke import deep_contact_state as deep_contact

M = 33


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_levels_and_restriction_matrix():
    for m in (5, 9, 12, 33, 65, 1025):
        assert mg._levels_for(m) == ref_mg._levels_for(m)
    np.testing.assert_array_equal(
        mg._restriction_matrix(M, np.float32),
        ref_mg._restriction_matrix(M, np.float32))


@pytest.mark.parametrize("op", ["restrict", "prolong", "k5_apply"])
def test_transfer_and_stencil_match_reference(op):
    rng = np.random.default_rng(4)
    shape = (17, 17) if op == "prolong" else (M, M)
    v = rng.standard_normal(shape).astype(np.float32)
    ref = getattr(ref_mg, op)(jnp.asarray(v))
    got = getattr(mg, op)(_t(v))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-6


def test_mg_pc_application_matches_reference():
    alpha, free, B, C, w0, b, sq = deep_contact(M, 0)
    ref = ref_mg.make_mg_pc(M)(jnp.asarray(alpha, jnp.float32),
                               jnp.asarray(w0))(jnp.asarray(b))
    got = mg.make_mg_pc(M)(np.float32(alpha), _t(w0))(_t(b))
    assert _rel(got.numpy(), ref) <= 1e-6


def _scaled_problem(pkg, backend):
    """The Jacobi-scaled Schur matvec and its V-cycle preconditioner, as
    the reference's test_mgfused builds them, in either package."""
    alpha, free, B, C, w0, b, sq = deep_contact(M, 0)
    arr = (lambda a: jnp.asarray(a, jnp.float32)) if backend == "jax" \
        else _t
    B32, C32, free32 = arr(B), arr(C), arr(free.astype(np.float32))
    sq32 = arr(np.where(free, sq, 1.0))
    mgpc = pkg.make_mg_pc(M)(np.float32(alpha), arr(w0))

    def S32t(vt):
        y5 = pkg.k5_apply((B32 * vt).reshape(M, M)).reshape(-1)
        return np.float32(alpha) * B32 * (free32 * y5) + C32 * vt

    def pc(r):
        return sq32 * free32 * mgpc(sq32 * r)

    return S32t, pc, arr(b)


def test_pcg_matches_reference_deep_contact():
    tol, maxiter = 1e-6, 500
    S_r, pc_r, b_r = _scaled_problem(ref_mg, "jax")
    xr, itr = ref_mg.pcg(S_r, b_r, pc_r, tol, maxiter)
    S_t, pc_t, b_t = _scaled_problem(mg, "torch")
    xt, itt = mg.pcg(S_t, b_t, pc_t, tol, maxiter)
    assert abs(int(itt) - int(itr)) <= 3
    xr = np.asarray(xr)
    assert np.linalg.norm(xt.numpy() - xr) <= 1e-4 * np.linalg.norm(xr)
    rres = (torch.linalg.norm(b_t - S_t(xt)) / torch.linalg.norm(b_t))
    assert float(rres) < 5 * tol


def test_pcg_chunk_size_does_not_change_result():
    """The host reads the loop condition once per chunk; masked dead
    iterations are the identity, so any chunk gives the same bits."""
    S_t, pc_t, b_t = _scaled_problem(mg, "torch")
    x1, i1 = mg.pcg(S_t, b_t, pc_t, 1e-6, 500, chunk=1)
    x7, i7 = mg.pcg(S_t, b_t, pc_t, 1e-6, 500, chunk=7)
    assert int(i1) == int(i7)
    assert torch.equal(x1, x7)


def test_pcg_zero_rhs_matches_reference():
    S_r, pc_r, b_r = _scaled_problem(ref_mg, "jax")
    xr, itr = ref_mg.pcg(S_r, jnp.zeros_like(b_r), pc_r, 1e-6, 500)
    S_t, pc_t, b_t = _scaled_problem(mg, "torch")
    xt, itt = mg.pcg(S_t, torch.zeros_like(b_t), pc_t, 1e-6, 500)
    assert int(itt) == int(itr) == 0
    assert float(xt.abs().max()) == 0.0
