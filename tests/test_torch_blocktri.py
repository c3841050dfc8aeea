"""The port's block-tridiagonal direct solver (la/blocktri.py, pc_type=
'btlu') against the reference's, on the CPU, at the sizes of the
reference's tests/test_blocktri.py: LineBlocking's maps bit-identical on
the lattice and on the irregular-point graph fallback, the f32 and f64
factors held to the reference's factors and to exact LU, directions equal
to exact LU, cyclic reduction against the dense solve, full gradient-
constraint LVPP trajectories (Thomas f32, streamed, lagged f64 factor /
f32 apply, cyclic reduction) with counts identical to the reference's LU
run, the unstructured-disk obstacle against host LU (its graph blocking
bit-identical to the reference's), and the f64 block
inverse on the cross-scale block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.la import blocktri as ref_bt
from proximalgalerkin_tpu.models.gradient_constraint import \
    setup_gradient_constraint as ref_setup

from proximalgalerkin_torch.core.config import SolverOptions
from proximalgalerkin_torch.la import blocktri as bt
from proximalgalerkin_torch.la.direct import LUFactorization
from proximalgalerkin_torch.models.gradient_constraint import \
    setup_gradient_constraint
from proximalgalerkin_torch.solve.newton import NewtonSolver

KW16 = dict(N=16, M=16, primal_degree=2, max_iterations=3,
            stopping_tol=1e-8, verbose=False, quadrature_degree=6)
KW12 = dict(N=12, M=12, primal_degree=2, max_iterations=25,
            stopping_tol=1e-8, verbose=False, quadrature_degree=6)

# Full-LVPP cases of tests/test_blocktri.py: (solver options, ksp_rtol).
# Cyclic reduction refines to 1e-11 as in the reference test (at 1e-9 a
# deep-alpha Newton increment lands on the other side of its threshold).
LVPP_CASES = {
    "thomas_f32": {"ksp_rtol": 1e-9},
    "streamed": {"pc_factor_streamed": True, "ksp_rtol": 1e-9},
    "lagged_f64_f32apply": {"pc_factor_lag": 1, "pc_factor_dtype": "f64",
                            "pc_factor_apply_dtype": "f32",
                            "ksp_rtol": 1e-9},
    "cr": {"pc_factor_algo": "cr", "ksp_rtol": 1e-11},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grad16():
    """The reference's state after 3 LVPP steps at 16^2 P2, and the port's
    problem of the same setup."""
    rprob = ref_setup(**KW16)
    res3 = rprob.solver.solve(rprob.x0)
    prob = setup_gradient_constraint(device="cpu", **KW16)
    return rprob, prob, np.asarray(res3.x)


@pytest.fixture(scope="module")
def lu12():
    """The reference's LU trajectory at 12^2 P2 (the golden of every
    full-LVPP case)."""
    p = ref_setup(**KW12)
    return p.solver.solve(p.x0)


def _at_state(rprob, prob, x, alpha):
    """Both problems at x with the previous iterate x and alpha."""
    rp = rprob.solver.newton.problem
    rp.update(coeffs=rprob.solver.prev_coeffs(jnp.asarray(x)),
              consts={"alpha": jnp.asarray(alpha)})
    p = prob.solver.newton.problem
    xt = torch.as_tensor(x)
    p.update(coeffs=prob.solver.prev_coeffs(xt),
             consts={"alpha": torch.tensor(alpha, dtype=torch.float64)})
    return rp, p, xt


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _maps_equal(blk, rblk):
    assert (blk.nb, blk.bs, blk.dense_ok) == (rblk.nb, rblk.bs,
                                              rblk.dense_ok)
    for k in ("rhs_idx", "tgt_d", "tgt_l", "tgt_u", "pad_idx"):
        a, r = getattr(blk, k), getattr(rblk, k)
        assert a.dtype == r.dtype, k
        np.testing.assert_array_equal(a, r, err_msg=k)
    sm = blk.streamed_maps(torch.device("cpu"))
    rsm = rblk.streamed_maps()
    assert set(sm) == set(rsm)
    for k in sm:
        np.testing.assert_array_equal(sm[k].numpy(), np.asarray(rsm[k]),
                                      err_msg=k)


def test_line_blocking_matches_reference(grad16):
    """The lattice blocking of the 16^2 P2 problem: nb, bs, every scatter
    map and the streamed maps bit-identical to the reference's."""
    rprob, prob, _ = grad16
    rblk = rprob.solver.newton.problem.line_blocking()
    blk = prob.solver.newton.problem.line_blocking()
    assert blk.nb >= 3
    _maps_equal(blk, rblk)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_factor_matches_reference(grad16, dtype):
    """On the same state, bt_assemble's blocks equal the reference's to
    the rounding of the assembled data (f64 1e-13; f32 1e-6, one f32
    rounding), the Thomas factor (Minv, T) of the port's blocks equals the
    reference's factor of the same blocks (f64 1e-12, f32 1e-5: LU
    inverses of two builds round differently), and one refinement-free
    apply gives the reference's direction and exact LU's to the factor's
    precision (f64 1e-12, f32 1e-5)."""
    rprob, prob, x = grad16
    rp, p, xt = _at_state(rprob, prob, x, 8.0)
    rblk = rp.line_blocking()
    blk = p.line_blocking()
    rdata = rp.ell_data(jnp.asarray(x))
    data = p.ell_data(xt)
    assert _rel(data.numpy(), np.asarray(rdata)) <= 1e-14
    cols = p.ell_matrix.arrays["ell_cols"]
    maps, rmaps = blk.device_maps("cpu"), rblk.device_maps()
    D, L, U, s = bt.bt_assemble(data, cols, maps, blk.nb, blk.bs, dtype)
    rD, rL, rU, rs = ref_bt.bt_assemble(
        rdata, rp.ell_matrix.arrays["ell_cols"], rmaps, rblk.nb, rblk.bs,
        dtype)
    fdt = torch.float32 if dtype == "f32" else torch.float64
    assert D.dtype == L.dtype == U.dtype == fdt and s.dtype == torch.float64
    assert _rel(s.numpy(), np.asarray(rs)) <= 1e-13
    for a, r in ((D, rD), (L, rL), (U, rU)):
        assert _rel(a.numpy(), np.asarray(r)) <= (1e-13 if dtype == "f64"
                                                  else 1e-6)
    Minv, T = bt.bt_factor(D, L, U)
    rMinv, rT = ref_bt.bt_factor(*(jnp.asarray(a.numpy())
                                   for a in (D, L, U)))
    tol = 1e-12 if dtype == "f64" else 1e-5
    assert _rel(Minv.numpy(), np.asarray(rMinv)) <= tol
    assert _rel(T.numpy(), np.asarray(rT)) <= tol
    F = p.residual(xt)
    A = p.jacobian_scipy(xt)
    dx_lu = LUFactorization(A).solve(-F.numpy())
    dx = bt.bt_solve(Minv, T, L, s, -F, maps, blk.nb, blk.bs).numpy()
    rdx = np.asarray(ref_bt.bt_solve(rMinv, rT, rL, rs,
                                     -jnp.asarray(F.numpy()), rmaps,
                                     rblk.nb, rblk.bs))
    assert np.linalg.norm(dx - dx_lu) / np.linalg.norm(dx_lu) < tol
    assert np.linalg.norm(dx - rdx) / np.linalg.norm(rdx) < tol


def test_direction_matches_lu(grad16):
    """btlu direction == exact host-LU direction to ksp_rtol, at a
    representative mid-LVPP state and a deep-alpha state (the reference
    test's bounds: relative residual 1e-11, direction 1e-8)."""
    rprob, prob, x = grad16
    for alpha in (8.0, 131072.0):
        _, p, xt = _at_state(rprob, prob, x, alpha)
        F = p.residual(xt)
        A = p.jacobian_scipy(xt)
        dx_lu = LUFactorization(A).solve(-F.numpy())
        ns = NewtonSolver(p, SolverOptions(
            {"ksp_type": "preonly", "pc_type": "btlu",
             "ksp_rtol": 1e-12, "ksp_atol": 0.0}))
        dx = ns._solve_linear(xt, F).numpy()
        rres = np.linalg.norm(A @ dx + F.numpy()) / np.linalg.norm(F.numpy())
        derr = np.linalg.norm(dx - dx_lu) / np.linalg.norm(dx_lu)
        assert rres < 1e-11, (alpha, rres)
        assert derr < 1e-8, (alpha, derr)
        assert ns.timer.counts["bt_factor"] == 1 and ns.refactors == 1


def test_streamed_matches_dense(grad16):
    """The streamed factor/apply (only Minv stored; D/L/U scattered per
    step from the ELL data) gives the dense path's direction (1e-5: the
    same f32 math in another association order) and the reference's
    streamed direction (1e-4)."""
    rprob, prob, x = grad16
    rp, p, xt = _at_state(rprob, prob, x, 8.0)
    F = p.residual(xt)
    data64 = p.ell_data(xt)
    ell = p.ell_matrix
    blk = p.line_blocking()
    dense = bt.BlockTriFactorization(blk, ell, data64, ell.arrays)
    streamed = bt.StreamedBlockTriFactorization(blk, ell, data64, ell.arrays)
    xd = dense.solve(-F).numpy()
    xs = streamed.solve(-F).numpy()
    assert np.linalg.norm(xs - xd) / np.linalg.norm(xd) < 1e-5
    rdata = rp.ell_data(jnp.asarray(x))
    rs = ref_bt.StreamedBlockTriFactorization(
        rp.line_blocking(), rp.ell_matrix, rdata, rp.ell_matrix.arrays)
    xr = np.asarray(rs.solve(-jnp.asarray(F.numpy())))
    assert np.linalg.norm(xs - xr) / np.linalg.norm(xr) < 1e-4


@pytest.mark.parametrize("case", list(LVPP_CASES))
def test_full_lvpp_trajectory_matches_lu(lu12, case):
    """Full gradient-constraint LVPP at 12^2 P2 with btlu directions
    (Thomas f32, streamed, lagged f64 factor with f32 apply, cyclic
    reduction) reproduces the reference's LU trajectory: identical LVPP
    and per-step Newton counts, x within 1e-7 relative."""
    prob = setup_gradient_constraint(
        device="cpu", solver_options={"ksp_type": "preonly",
                                      "pc_type": "btlu",
                                      **LVPP_CASES[case]}, **KW12)
    res = prob.solver.solve(prob.x0)
    assert res.converged
    assert res.iterations == lu12.iterations
    assert list(res.newton_steps) == list(lu12.newton_steps)
    ref_x = np.asarray(lu12.x)
    diff = np.linalg.norm(res.x.numpy() - ref_x) / np.linalg.norm(ref_x)
    assert diff < 1e-7
    newton = prob.solver.newton
    if case == "lagged_f64_f32apply":
        # the lagged factor serves several Newton steps
        assert 1 <= newton.refactors < res.total_newton
    else:
        assert newton.refactors == res.total_newton


def test_cyclic_reduction_matches_dense():
    """bt_factor_cr/bt_apply_cr solve random quasi-definite block-
    tridiagonal systems to the dense solve's accuracy (1e-10), as the
    reference's do, including non-power-of-two block counts (identity
    padding); the CR factor's levels and root agree with the reference's
    (1e-12)."""
    rng = np.random.default_rng(0)
    for nb, bs in [(3, 4), (7, 8), (12, 8), (17, 4)]:
        D = rng.standard_normal((nb, bs, bs)) * 0.3
        sgn = np.where(rng.random((nb, bs)) > 0.5, 4.0, -4.0)
        D += np.einsum("kb,bc->kbc", sgn, np.eye(bs))
        L = rng.standard_normal((nb - 1, bs, bs)) * 0.3
        U = rng.standard_normal((nb - 1, bs, bs)) * 0.3
        b = rng.standard_normal((nb, bs))
        A = np.zeros((nb * bs, nb * bs))
        for k in range(nb):
            A[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = D[k]
        for k in range(nb - 1):
            A[(k + 1) * bs:(k + 2) * bs, k * bs:(k + 1) * bs] = L[k]
            A[k * bs:(k + 1) * bs, (k + 1) * bs:(k + 2) * bs] = U[k]
        x_ref = np.linalg.solve(A, b.reshape(-1)).reshape(nb, bs)
        lv, root = bt.bt_factor_cr(*map(torch.as_tensor, (D, L, U)))
        x_cr = bt.bt_apply_cr(lv, root, torch.as_tensor(b)).numpy()
        assert np.abs(x_cr - x_ref).max() < 1e-10 * max(
            1.0, np.abs(x_ref).max()), (nb, bs)
        x_th = bt.bt_apply(*bt.bt_factor(*map(torch.as_tensor, (D, L, U))),
                           torch.as_tensor(L), torch.as_tensor(b)).numpy()
        assert np.abs(x_th - x_ref).max() < 1e-10 * max(
            1.0, np.abs(x_ref).max()), (nb, bs)
        rlv, rroot = ref_bt.bt_factor_cr(*map(jnp.asarray, (D, L, U)))
        assert len(lv) == len(rlv)
        for lev, rlev in zip(lv, rlv):
            for a, r in zip(lev, rlev):
                assert a.shape == r.shape
                if a.numel():
                    assert _rel(a.numpy(), np.asarray(r)) <= 1e-12
        assert _rel(root.numpy(), np.asarray(rroot)) <= 1e-12


def test_irregular_points_get_graph_blocking():
    """Fully irregular point sets (no coordinate line structure) fall
    back to BFS level-set blocking of the dof GRAPH; the port's blocking
    and maps are bit-identical to the reference's, every dof lands once
    in the block vector, and the blocked matrix is block-tridiagonal
    (build() raises otherwise)."""
    from proximalgalerkin_tpu.la.ell import EllPattern as RefPattern
    from proximalgalerkin_torch.la.ell import EllPattern
    rng = np.random.default_rng(0)
    ncell, ld, ndof = 400, 3, 260
    conn = rng.integers(0, ndof, size=(ncell, ld))
    pattern = EllPattern.build(conn, ndof, np.empty(0, np.int64))
    pts = rng.standard_normal((ndof, 2))
    blk = bt.LineBlocking.build(pattern, pts)
    rblk = ref_bt.LineBlocking.build(
        RefPattern.build(conn, ndof, np.empty(0, np.int64)), pts)
    assert blk.nb >= 3
    assert blk.nb * blk.bs >= ndof
    assert len(np.unique(blk.rhs_idx)) == ndof
    _maps_equal(blk, rblk)


def test_unstructured_disk_btlu_matches_lu():
    """Obstacle problem on the unstructured disk (res 0.15) with btlu
    directions (graph BFS blocking + f64 factor): LVPP/Newton counts equal
    the reference's host-LU run, x within 1e-8."""
    from proximalgalerkin_tpu.mesh.unstructured import \
        create_disk_mesh as ref_disk
    from proximalgalerkin_tpu.models.obstacle import \
        solve_obstacle_problem as ref_solve
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_torch.models.obstacle import solve_obstacle_problem
    common = dict(polynomial_order=1, tol_exit=1e-6, verbose=False,
                  maximum_number_of_outer_loop_iterations=30)
    rprob, r_lu = ref_solve(ref_disk(res=0.15), **common)
    prob, r_bt = solve_obstacle_problem(
        create_disk_mesh(res=0.15), device="cpu",
        solver_options={"ksp_type": "preonly", "pc_type": "btlu",
                        "ksp_rtol": 1e-9, "pc_factor_dtype": "f64"},
        **common)
    assert r_bt.converged and r_lu.converged
    assert r_bt.iterations == r_lu.iterations
    assert list(r_bt.newton_steps) == list(r_lu.newton_steps)
    ref_x = np.asarray(r_lu.x)
    diff = np.linalg.norm(r_bt.x.numpy() - ref_x) / \
        max(np.linalg.norm(ref_x), 1.0)
    assert diff < 1e-8
    # the blocking of the disk is the reference's, bit for bit
    _maps_equal(prob.problem.line_blocking(), rprob.problem.line_blocking())


def test_block_inv_f64_cross_scale():
    """The f64 block inverse on the reference's cross-scale block (unit
    diagonal, off-diagonal coupling ~1e8, cond ~1e16 — the deep-contact
    structure its f32-based 'schur' scheme exists for on the TPU) meets
    the same row-scaled residual bound, |M X - I| / rowsum|M| < 1e-9."""
    rng = np.random.default_rng(3)
    n = 96
    k = n // 2
    Q = rng.standard_normal((k, k))
    A = Q @ Q.T / k + np.eye(k)
    B = 1e8 * rng.standard_normal((k, k)) / np.sqrt(k)
    Q2 = rng.standard_normal((k, k))
    D = Q2 @ Q2.T / k + np.eye(k)
    M = np.block([[A, B], [B.T, -D]])
    X = bt._block_inv(torch.as_tensor(M)).numpy()
    R = M @ X - np.eye(n)
    assert np.isfinite(X).all()
    rs = np.abs(M).sum(axis=1)
    scaled = float((np.abs(R) / rs[:, None]).max())
    assert scaled < 1e-9, scaled


def test_block_inv_schur_cross_scale():
    """pc_factor_blockinv 'schur' on the reference's cross-scale block
    (tests/test_blocktri.py::test_block_inv_schur_cross_scale, leaf 32):
    the recursive block elimination meets the reference test's row-scaled
    residual bound, batched blocks give each block's own inverse, and an
    f32 block takes the LU inverse as in the reference."""
    rng = np.random.default_rng(3)
    n = 96
    k = n // 2
    Q = rng.standard_normal((k, k))
    A = Q @ Q.T / k + np.eye(k)
    B = 1e8 * rng.standard_normal((k, k)) / np.sqrt(k)
    Q2 = rng.standard_normal((k, k))
    D = Q2 @ Q2.T / k + np.eye(k)
    M = np.block([[A, B], [B.T, -D]])
    X = bt._block_inv_schur(torch.as_tensor(M), leaf=32).numpy()
    assert np.isfinite(X).all()
    rs = np.abs(M).sum(axis=1)
    scaled = float((np.abs(M @ X - np.eye(n)) / rs[:, None]).max())
    assert scaled < 1e-9, scaled
    Mb = torch.as_tensor(np.stack([M, M.T @ M / 1e16 + np.eye(n)]))
    Xb = bt._block_inv_schur(Mb, leaf=32)
    for i in range(2):
        assert torch.equal(Xb[i], bt._block_inv_schur(Mb[i], leaf=32))
    M32 = torch.as_tensor(M[:k, :k], dtype=torch.float32)
    assert torch.equal(bt._block_inv(M32, "schur"), bt._block_inv(M32))


def test_equilibrate_leaves_rounding_zero_diagonals_unscaled():
    """_equilibrate scales each row by |diag|^-1/2, the reference's scale
    to 1e-15, except where the diagonal is zero to f64 rounding of its
    row (|diag| <= eps max|row|): that row keeps scale 1, as the
    reference keeps a zero diagonal."""
    rng = np.random.default_rng(5)
    N, K = 40, 5
    rows = np.arange(N)
    cols = np.stack([rows] + [(rows + rng.integers(1, N, N)) % N
                              for _ in range(K - 1)], axis=1)
    data = rng.standard_normal((N, K))
    data[:, 0] = np.abs(data[:, 0]) + 0.5
    tiny = np.array([3, 17, 29])
    data[tiny, 0] = [1e-75, 1e-40, 0.0]
    data_s, s = bt._equilibrate(torch.as_tensor(data), torch.as_tensor(cols))
    _, ref_s = ref_bt.bt_equilibrate(jnp.asarray(data), jnp.asarray(cols),
                                     "f64")
    want = np.ones(N)
    live = np.setdiff1d(np.arange(N), tiny)
    want[live] = 1.0 / np.sqrt(np.abs(data[live, 0]))
    assert np.array_equal(s.numpy(), want)
    assert np.array_equal(data_s.numpy(), want[:, None] * data * want[cols])
    assert np.allclose(s.numpy()[live], np.asarray(ref_s)[live],
                       rtol=1e-15, atol=0.0)


def test_bad_options_raise(grad16):
    """The reference's loud refusals: an unknown pc_factor_algo, CR on the
    streamed layout, an f64 apply of an f32 factor; and an unknown
    pc_factor_blockinv."""
    rprob, prob, x = grad16
    _, p, xt = _at_state(rprob, prob, x, 8.0)
    F = p.residual(xt)
    for opts, what in (({"pc_factor_algo": "lu"}, "pc_factor_algo"),
                       ({"pc_factor_algo": "cr", "pc_factor_streamed": True},
                        "streamed"),
                       ({"pc_factor_apply_dtype": "f64"}, "apply_dtype"),
                       ({"pc_factor_blockinv": "qr"}, "blockinv")):
        ns = NewtonSolver(p, SolverOptions(
            {"ksp_type": "preonly", "pc_type": "btlu", **opts}))
        with pytest.raises(ValueError, match=what):
            ns._solve_linear(xt, F)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_obstacle_40_btlu_outcome_matches_reference(dtype):
    """The obstacle LVPP on the 40^2 P1 square (phase 9's protocol of
    chip_smoke.py: double-exponential alpha to 1e2, tol_exit 1e-6) with
    btlu directions at ksp_rtol 1e-9: with either factor dtype the port
    takes the reference's f64 btlu run's outer count and per-step Newton
    counts, converges as it does, and x agrees to 1e-8 relative. (The
    reference's f32 factor breaks down at outer step 6: its Jacobi
    equilibration scales latent rows by diagonals near underflow, and the
    block elimination overflows f32; the port leaves a row whose diagonal
    is zero to rounding unscaled, la/blocktri._equilibrate.)"""
    from proximalgalerkin_tpu.mesh import rectangle_mesh as ref_rect
    from proximalgalerkin_tpu.models.obstacle import \
        setup_obstacle_problem as ref_setup_obstacle
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models.obstacle import \
        setup_obstacle_problem
    kw = dict(polynomial_order=1, alpha_scheme="double_exponential",
              alpha_max=1e2, tol_exit=1e-6, verbose=False)

    def opts(fdt):
        return {"solver_options": {"ksp_type": "preonly", "pc_type": "btlu",
                                   "ksp_rtol": 1e-9, "pc_factor_dtype": fdt}}

    box = dict(p0=(-1.0, -1.0), p1=(1.0, 1.0))
    r_ref = ref_setup_obstacle(ref_rect(40, 40, **box), **kw,
                               **opts("f64")).solve()
    r = setup_obstacle_problem(rectangle_mesh(40, 40, **box), device="cpu",
                               **kw, **opts(dtype)).solve()
    assert r.iterations == r_ref.iterations
    assert list(r.newton_steps) == list(r_ref.newton_steps)
    assert r.converged and r_ref.converged
    ref_x = np.asarray(r_ref.x)
    assert _rel(r.x.numpy(), ref_x) < 1e-8


def _bt_inputs(lead, nb, bs, dtype, seed):
    """A block-Thomas apply's inputs: Minv, T, L with norms about 0.5
    (standard normal entries scaled by 0.25 / sqrt(bs)), b standard
    normal; `lead` the batch axes."""
    rng = np.random.default_rng(seed)
    sc = 0.25 / np.sqrt(bs)

    def r(*shape, s=1.0):
        return torch.as_tensor(rng.standard_normal(lead + shape) * s,
                               dtype=dtype)

    return (r(nb, bs, bs, s=sc), r(nb - 1, bs, bs, s=sc),
            r(nb - 1, bs, bs, s=sc), r(nb, bs))


@pytest.mark.parametrize("lead, nb, bs, dtype", [
    ((3,), 7, 5, torch.float64), ((), 4, 6, torch.float64),
    ((2, 2), 3, 4, torch.float32), ((2,), 1, 3, torch.float64)])
def test_bt_apply_on_cpu_is_the_plain_version(lead, nb, bs, dtype):
    """On CPU tensors bt_apply is bt_apply_reference, bit for bit; an
    unbatched apply agrees with the JAX package's bt_apply."""
    Minv, T, L, b = _bt_inputs(lead, nb, bs, dtype, nb * bs)
    x = bt.bt_apply(Minv, T, L, b)
    assert x.shape == b.shape and x.dtype == dtype
    assert torch.equal(x, bt.bt_apply_reference(Minv, T, L, b))
    if not lead and nb > 1:
        xr = ref_bt.bt_apply(*(jnp.asarray(t.numpy()) for t in (Minv, T, L,
                                                                  b)))
        assert _rel(x.numpy(), np.asarray(xr)) <= 1e-13


def test_bt_apply_rejects_bad_inputs():
    """A mismatched dtype, a dtype the kernel does not take, a shape that
    is not the factor's, mismatched batch axes, a non-contiguous factor or
    right-hand side: raised on the CPU as on a card."""
    Minv, T, L, b = _bt_inputs((2,), 5, 4, torch.float64, 0)
    with pytest.raises(TypeError):
        bt.bt_apply(Minv.float(), T, L, b)
    with pytest.raises(TypeError):
        bt.bt_apply(Minv, T, L.float(), b)
    with pytest.raises(TypeError):
        bt.bt_apply(*(t.to(torch.float16) for t in (Minv, T, L, b)))
    with pytest.raises(ValueError):
        bt.bt_apply(Minv[:, :4].contiguous(), T, L, b)
    with pytest.raises(ValueError):
        bt.bt_apply(Minv, T[:, :3].contiguous(), L, b)
    with pytest.raises(ValueError):
        bt.bt_apply(Minv, T, L, b[:1])
    with pytest.raises(ValueError):
        bt.bt_apply(Minv, T, L, b.reshape(-1))
    with pytest.raises(ValueError):
        bt.bt_apply(Minv.transpose(-1, -2), T, L, b)
    with pytest.raises(ValueError):
        bt.bt_apply(Minv, T, L.transpose(-1, -2), b)
    with pytest.raises(ValueError):
        bt.bt_apply(Minv, T, L, b.transpose(-1, -2).contiguous()
                    .transpose(-1, -2))


def test_refine_counts_the_applies_the_kernel_served():
    """`bt.apply_kernel`: refine counts one in each `bt.apply` span whose
    solve launched the kernel (bt_apply.launches moved, as the wrapper
    moves it on a card), and none where the plain version served it."""
    from proximalgalerkin_torch.core.logging import (counter, recorded, span,
                                                     tracing)
    rng = np.random.default_rng(5)
    A = torch.as_tensor(np.eye(6) * 2.0 + 0.1 * rng.standard_normal((6, 6)))
    # a solve with an inexact inverse, so refinement takes passes
    inv = torch.linalg.inv(A + 0.05 * torch.eye(6, dtype=torch.float64))
    b = torch.as_tensor(rng.standard_normal(6))

    def plain(v):
        return inv @ v

    def kernel_served(v):
        bt.bt_apply.launches += 1
        return inv @ v

    stop2 = torch.tensor(1e-60, dtype=torch.float64)
    for solve, per_apply in ((kernel_served, 1), (plain, None)):
        before = counter("bt.apply_kernel")
        with tracing():
            with span("test.refine"):
                dx, _, p = bt.refine(solve, lambda v: A @ v, b, stop2, 5)
        group = [g for g in recorded() if g[0].name == "test.refine"][-1]
        applies = [s for s in group if s.name == "bt.apply"]
        assert len(applies) == int(p) + 1 >= 3
        assert all(s.counts.get("bt.apply_kernel") == per_apply
                   for s in applies)
        assert counter("bt.apply_kernel") - before == (
            len(applies) if per_apply else 0)
        assert _rel(dx.numpy(), np.linalg.solve(A.numpy(), b.numpy())) \
            <= 1e-6
