"""The port's block-Schur preconditioners (la/schur.py) and the
pc='schur'/'schur_mg' directions of solve/nonlinear.py against the
reference's, on the CPU: the negative block0 orientation of the
gradient-constraint saddle (tests/test_krylov.py:147-182), the
mixed-precision schur/schur_mg directions against LU
(tests/test_gradient_constraint.py:57-91), Minv(r) of make_schur_pc and
make_schur_mg_pc against the JAX package's on the same ELL data within
1e-12 in f64, the pc_schur_*/pc_mg_nu options through NewtonSolver, and
the fused Newton with pc='schur'/'schur_mg' against the JAX package's
(counts identical, x within 1e-8), and the first mixed schur_mg
direction of both packages at 16^2, 32^2 and 64^2, refined and, at
64^2, without refinement."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.la import schur as ref_schur
from proximalgalerkin_tpu.models.gradient_constraint import \
    setup_gradient_constraint as ref_setup

from proximalgalerkin_torch.la import krylov, schur
from proximalgalerkin_torch.la.direct import LUFactorization
from proximalgalerkin_torch.la.gmg import lattice_map, mg_levels_for
from proximalgalerkin_torch.models.gradient_constraint import \
    setup_gradient_constraint

f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(space, bc_idx):
    m0 = np.zeros(space.num_dofs)
    m0[space.slice_of("psi")] = 1.0
    bc1 = np.zeros(space.num_dofs)
    bci = np.asarray(bc_idx)
    bc1[bci] = 1.0 - m0[bci]
    return m0, bc1


def test_schur_negative_block_orientation_gradient_constraint():
    """Block-Schur orients itself by the block0 diagonal sign: the
    gradient-constraint latent row (grad u - map) has a NEGATIVE block
    diagonal; MINRES with the oriented preconditioner converges."""
    prob = setup_gradient_constraint(N=8, verbose=False, device="cpu")
    p = prob.solver.newton.problem
    form = p.form
    for k in form.coeff_spaces:
        if k not in p.coeffs:
            p.coeffs[k] = torch.zeros(form.coeff_spaces[k].num_dofs,
                                      dtype=f64)
    x = p.set_bc(torch.zeros(prob.space.num_dofs, dtype=f64))
    F = p.residual(x)
    ell = p.ell_matrix
    data = ell.assemble(form._element_matrices_core(x, p.coeffs, p.consts))
    m0, bc1 = _masks(prob.space, p.bc_idx)
    Minv = schur.make_schur_pc(ell, data, torch.as_tensor(m0),
                               torch.as_tensor(bc1), cheb_steps=8)
    b = -F
    xs, rn, its = krylov.minres_info(lambda v: ell.spmv(data, v), b,
                                     tol=1e-10, maxiter=5000, Minv=Minv)
    rel = float(torch.linalg.norm(ell.spmv(data, xs) - b)
                / torch.linalg.norm(b))
    assert rel < 1e-8
    assert 1 < int(its) < 5000


@pytest.fixture(scope="module")
def state16():
    """tests/test_gradient_constraint.py:57-91's state in both packages:
    three LVPP steps of the 16^2 P2 problem, then alpha = 8."""
    kw = dict(N=16, M=16, primal_degree=2, max_iterations=3,
              stopping_tol=1e-8, verbose=False, quadrature_degree=6)
    prob = setup_gradient_constraint(device="cpu", **kw)
    x = prob.solver.solve(prob.x0).x
    p = prob.solver.newton.problem
    p.update(coeffs=prob.solver.prev_coeffs(x),
             consts={"alpha": torch.tensor(8.0, dtype=f64)})
    rprob = ref_setup(**kw)
    rx = jnp.asarray(rprob.solver.solve(rprob.x0).x)
    rp = rprob.solver.newton.problem
    rp.update(coeffs=rprob.solver.prev_coeffs(rx),
              consts={"alpha": jnp.asarray(8.0)})
    return prob, p, x, rp, rx


@pytest.mark.parametrize("pc", ["schur", "schur_mg"])
def test_mixed_precision_schur_direction_beats_1e6_stall(state16, pc):
    """The mixed-precision (f32 inner + f64 refinement) direction with the
    block-Schur and lattice-MG preconditioners reaches a 1e-8 relative
    residual on the gradient-constraint saddle system, and LU's direction
    within 1e-7."""
    _, p, x, _, _ = state16
    F = p.residual(x)
    fn = float(torch.linalg.norm(F))
    A = p.jacobian_scipy(x)
    dx_lu = LUFactorization(A).solve(-F.numpy())
    step = p.direction_solver("minres", pc, schur_field0="psi",
                              precision="mixed")
    dx = step(x, F, p.coeffs, p.consts, 1e-10, 0.0, 2000).numpy()
    r = np.linalg.norm(A @ dx + F.numpy()) / fn
    derr = np.linalg.norm(dx - dx_lu) / np.linalg.norm(dx_lu)
    assert r < 1e-8, (pc, r)
    assert derr < 1e-7, (pc, derr)


@pytest.mark.parametrize("pc", ["schur", "schur_mg"])
def test_minv_matches_reference(state16, pc):
    """Minv(r) of the port's preconditioner on the JAX package's ELL
    Jacobian data (f64, at the 16^2 state) against the JAX package's
    within 1e-12 relative, on three right-hand sides."""
    prob, p, x, rp, rx = state16
    rell = rp.ell_matrix
    rdata = rell.assemble(rp.form.element_matrices(rx, rp.coeffs, rp.consts))
    ell = p.ell_matrix
    np.testing.assert_array_equal(ell.pattern.ell_cols,
                                  rell.pattern.ell_cols)
    data = torch.as_tensor(np.array(rdata))
    m0, bc1 = _masks(prob.space, p.bc_idx)
    if pc == "schur":
        kw = dict(cheb_steps=6, power_iters=12, lmin_ratio=20.0)
        Minv = schur.make_schur_pc(ell, data, torch.as_tensor(m0),
                                   torch.as_tensor(bc1), **kw)
        rMinv = ref_schur.make_schur_pc(rell, rdata, rell.arrays,
                                        jnp.asarray(m0), jnp.asarray(bc1),
                                        **kw)
    else:
        U = prob.space.spaces["u"]
        perm_loc, shape = lattice_map(U.dof_points)
        perm = prob.space.offsets["u"] + perm_loc
        bc_set = np.zeros(prob.space.num_dofs, bool)
        bc_set[np.asarray(p.bc_idx)] = True
        free = (~bc_set[perm]).reshape(shape)
        levels = mg_levels_for(min(shape))
        assert levels == 2
        Minv = schur.make_schur_mg_pc(
            ell, data, torch.as_tensor(m0), torch.as_tensor(bc1),
            torch.as_tensor(perm), shape, torch.as_tensor(free), levels,
            nu=3)
        rMinv = ref_schur.make_schur_mg_pc(
            rell, rdata, rell.arrays, jnp.asarray(m0), jnp.asarray(bc1),
            jnp.asarray(perm), shape, jnp.asarray(free), levels, nu=3)
    rng = np.random.default_rng(7)
    for _ in range(3):
        r = rng.standard_normal(prob.space.num_dofs)
        got = Minv(torch.as_tensor(r)).numpy()
        want = np.asarray(rMinv(jnp.asarray(r)))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_schur_options_reach_the_preconditioner(state16, monkeypatch):
    """NewtonSolver hands pc_schur_cheb_steps, pc_schur_power_iters,
    pc_schur_lmin_ratio and pc_mg_nu to the preconditioner, in solve()
    and in the fused Newton."""
    from proximalgalerkin_torch.core.config import SolverOptions
    from proximalgalerkin_torch.solve import NewtonSolver
    _, p, x, _, _ = state16
    seen = []
    for name in ("make_schur_pc", "make_schur_mg_pc"):
        orig = getattr(schur, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append((_name, kw))
            return _orig(*a, **kw)

        monkeypatch.setattr(schur, name, spy)
    opts = {"ksp_type": "minres", "pc_schur_field0": "psi",
            "pc_schur_cheb_steps": 6, "pc_schur_power_iters": 7,
            "pc_schur_lmin_ratio": 20.0, "pc_mg_nu": 3, "snes_max_it": 1,
            "ksp_max_it": 5}
    for fused in (False, True):
        for pc in ("schur", "schur_mg"):
            seen.clear()
            p._direction_cache.clear()
            NewtonSolver(p, SolverOptions({**opts, "pc_type": pc,
                                           "snes_fused": fused})).solve(x)
            name, kw = seen[0]
            if pc == "schur":
                assert name == "make_schur_pc"
                assert kw == dict(cheb_steps=6, power_iters=7,
                                  lmin_ratio=20.0)
            else:
                assert name == "make_schur_mg_pc" and kw == dict(nu=3)
    p._direction_cache.clear()


@pytest.mark.parametrize("pc", ["schur", "schur_mg"])
def test_fused_newton_matches_reference(pc):
    """The first 3 LVPP steps of the gradient-constraint 8^2 P2 problem
    with the fused Newton and block-Schur MINRES in both packages: outer
    and per-step Newton counts identical, x within 1e-8 relative."""
    kw = dict(N=8, M=8, primal_degree=2, max_iterations=3,
              stopping_tol=1e-6, verbose=False, quadrature_degree=4,
              solver_options={"snes_fused": True, "ksp_type": "minres",
                              "pc_type": pc, "pc_schur_field0": "psi",
                              "ksp_rtol": 1e-10, "ksp_max_it": 4000})
    res = setup_gradient_constraint(device="cpu", **kw).solve()
    rres = ref_setup(**kw).solve()
    assert res.iterations == rres.iterations == 3
    assert res.newton_steps == rres.newton_steps
    rx = np.asarray(rres.x)
    assert np.abs(res.x.numpy() - rx).max() <= 1e-8 * np.abs(rx).max()


def _first_directions(n, refine_max=None):
    """The first Newton direction of the n^2 P2 gradient-constraint LVPP
    (alpha = 1, x0 = 0) with the mixed schur_mg direction (ksp_refine_max
    refine_max, None: the default 30) in the port and in the JAX package:
    [(dx, |J dx + F| / |F|)] each."""
    kw = dict(N=n, M=n, primal_degree=2, alpha_scheme="doubling",
              stopping_tol=1e-8, verbose=False)
    pc_opts = None if refine_max is None else {"ksp_refine_max": refine_max}
    out = []
    for prob, zeros, alpha in (
            (setup_gradient_constraint(device="cpu", **kw), torch.as_tensor,
             torch.tensor(1.0, dtype=f64)),
            (ref_setup(**kw), jnp.asarray, jnp.asarray(1.0))):
        p = prob.solver.newton.problem
        x0 = zeros(np.asarray(prob.x0))
        p.update(coeffs=prob.solver.prev_coeffs(x0), consts={"alpha": alpha})
        x = zeros(np.asarray(p.set_bc(x0)))
        F = p.residual(x)
        dx = p.direction_solver("minres", "schur_mg", schur_field0="psi",
                                precision="mixed", pc_opts=pc_opts)(
            x, F, p.coeffs, p.consts, 1e-10, 1e-50, 10_000)
        A = p.jacobian_scipy(x)
        F, dx = np.asarray(F), np.asarray(dx)
        out.append((dx, np.linalg.norm(A @ dx + F) / np.linalg.norm(F)))
    return out


@pytest.mark.parametrize("n", [16, 32])
def test_first_mixed_schur_mg_direction_matches_reference(n):
    """The first Newton direction of the n^2 P2 gradient-constraint LVPP
    (alpha = 1, x0 = 0) with the mixed schur_mg direction in both
    packages: the same direction within 1e-7 relative, each relative
    residual |J dx + F| / |F| under 1e-9."""
    (dx, rel), (rdx, rrel) = _first_directions(n)
    assert rel < 1e-9 and rrel < 1e-9, (rel, rrel)
    assert np.linalg.norm(dx - rdx) <= 1e-7 * np.linalg.norm(rdx)


def test_mixed_schur_mg_refinement_at_64():
    """At 64^2 the refined first direction's relative residual has grown
    to about 3e-9 in both packages (under 1e-11 at 16^2; it keeps growing
    with the mesh, to about 9e-7 at 200^2, where chip_smoke.py's phase 12
    (iv) holds it under 1e-5), while the f32 solve alone (ksp_refine_max
    0) stops near 4e-4 in both: each package's refined residual under
    1e-7 and its control's over 1e-5, and the two refined directions
    within 1e-8 relative."""
    (dx, rel), (rdx, rrel) = _first_directions(64)
    (_, rel0), (_, rrel0) = _first_directions(64, refine_max=0)
    assert rel < 1e-7 and rrel < 1e-7, (rel, rrel)
    assert rel0 > 1e-5 and rrel0 > 1e-5, (rel0, rrel0)
    assert np.linalg.norm(dx - rdx) <= 1e-8 * np.linalg.norm(rdx)
