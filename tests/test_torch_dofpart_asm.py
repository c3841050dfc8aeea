"""The restricted additive Schwarz options of the port's distributed
Newton (parallel/dofpart.py: asm_lu, a dense subdomain LU, and asm_btlu,
a block-tridiagonal subdomain factor, both under right-preconditioned
GMRES(120)) against the reference package, on the CPU with 8
subdomains: the two Schwarz cases of tests/test_dofpart.py's line-search
and Schur variants, the asm_btlu-against-Jacobi strength case, and one
asm_btlu GMRES solve through both packages' GMRES on the same operator.
The helpers are test_torch_dofpart_lvpp.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_torch.parallel.dofpart import DistributedLvppProblem

from test_torch_dofpart_lvpp import (VARIANT_OPTS, Pair,  # noqa: F401
                                     check_variant, variants)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The reference's Newton counts of the strength case's three runs (its
# distributed problem on 8 virtual CPU devices, the port's options)
REFERENCE_STEPS = {"exact": [5, 3, 3, 3, 3, 3, 3, 1, 3],
                   "strong": [5, 3, 3, 3, 3, 3, 3, 3],
                   "weak": [5, 3, 3, 3, 3, 3, 3, 1, 3]}
# The port's: the same. At the budget-capped Schwarz run's 8th LVPP step
# the count is drift of rounding, not a property of either package: the
# 150-iteration GMRES stops short of its tolerance there, and the
# classical-Gram-Schmidt Arnoldi basis amplifies a last-bit difference
# about twofold an iteration, so on the same operator the two GMRES
# agree to rounding only over their first iterations
# (test_gmres_matches_reference_gmres) and a 1-ulp change of the
# port's own right-hand side moves its last residual estimate as far
# (ROADMAP C, hazards). With the jvp action the port's step took two
# Newton steps (|F| / |F0| 7.8e-7 after two) where the reference takes
# three; with the element-matrix action of the Schwarz paths, equal to
# the jvp within 1e-15 relative (test_torch_ebe.py), it takes three
# (2.1e-6, 2.9e-6, 3.3e-7), steps 1-7 unchanged to four digits. Both
# stop at step 9 on a NaN residual.
PORT_STEPS = dict(REFERENCE_STEPS)


@pytest.mark.parametrize("tag", ["preonly/asm_lu", "preonly/asm_btlu"])
def test_distributed_linesearch_and_schur_variants(variants, tag):
    check_variant(variants, tag)


def test_asm_btlu_pc_strength_vs_jacobi():
    """The strong PC must help, not just converge: at deep-alpha
    conditioning (9 LVPP steps, alpha to ~1e5) with a per-direction
    Krylov budget of 150, RAS-btlu GMRES still lands within 1e-4 of the
    exact-direction solution while Jacobi-MINRES under the same budget is
    over 100x further off. Each run's Newton counts are held to
    PORT_STEPS, the reference's."""
    pair = Pair(0.2)
    kw = dict(tol=1e-50, max_iterations=9)
    runs = {"exact": {}, "strong": {"pc_type": "btlu", "ksp_type": "preonly",
                                    "ksp_max_it": 150},
            "weak": {"ksp_max_it": 150}}
    u = {}
    steps = {}
    for name, extra in runs.items():
        res, u[name] = pair.run(dict(VARIANT_OPTS, **extra), **kw)
        steps[name] = res.newton_steps
    assert steps == PORT_STEPS
    assert {k for k in steps if steps[k] != REFERENCE_STEPS[k]} == set()
    assert steps["strong"][:7] == REFERENCE_STEPS["strong"][:7]
    err_strong = np.max(np.abs(u["strong"] - u["exact"]))
    err_weak = np.max(np.abs(u["weak"] - u["exact"]))
    assert err_strong < 1e-4, err_strong
    assert err_weak > 100 * max(err_strong, 1e-12), (err_weak, err_strong)


def _residual_estimates(log, beta):
    """|g_j|, j = 0..k, of an Arnoldi process from the calls it made: the
    basis vectors V_j it handed the preconditioner and the images A M V_j
    (classical Gram-Schmidt against the whole basis, Givens rotations in
    f64 numpy); one routine for both packages' logs."""
    V = [v.ravel() for kind, v, _ in log if kind == "M"]
    W = [w.ravel() for kind, _, w in log if kind == "A"][1:]
    g, cs, sn, est = [beta], [], [], [beta]
    for j in range(len(W)):
        h = np.stack(V[:j + 1]) @ W[j]
        r = W[j] - h @ np.stack(V[:j + 1])
        col = list(h) + [np.sqrt(r @ r)]
        for k in range(j):
            col[k], col[k + 1] = (cs[k] * col[k] + sn[k] * col[k + 1],
                                  -sn[k] * col[k] + cs[k] * col[k + 1])
        d = np.hypot(col[j], col[j + 1])
        cs.append(col[j] / d)
        sn.append(col[j + 1] / d)
        g.append(-sn[j] * g[j])
        g[j] = cs[j] * g[j]
        est.append(abs(g[-1]))
    return np.asarray(est)


def test_gmres_matches_reference_gmres():
    """One asm_btlu system of the strength case (disk res 0.2, 8
    subdomains, its first Newton step at alpha 1): the reference's _gmres
    (over the shard axis, as in its distributed Newton) and the port's
    _gmres, both on the port's Jacobian action and Schwarz factor (the
    reference's calls them back), over the strength case's budget of 150
    iterations (GMRES(120), two cycles). Over the first 24 iterations
    every residual estimate agrees within 1e-12 relative. From there the
    classical-Gram-Schmidt bases part about twofold an iteration, and the
    port against itself with a right-hand side 1 ulp apart parts as far
    (its last estimate by more than 1e-3): the reference's distance from
    the port stays within 10 times the port's distance from its 1-ulp
    copy (or 1e-12) at every iteration of the first cycle, and so does
    the direction after all 150. Drift of rounding, not a fault
    (PORT_STEPS)."""
    pair = Pair(0.2)
    dp, rdp = pair.dp, pair.rdp
    dlp = DistributedLvppProblem(dp)
    dlp.update(consts={"alpha": torch.tensor(1.0, dtype=torch.float64)},
               coeffs={"phi": dp.scatter_cellq(
                   np.asarray(pair.prob.problem.coeffs["phi"])),
                       **{f"{f}_k": dp.field_to_coeff(
                           dp.scatter(np.zeros(pair.space.num_dofs)), f)
                          for f in ("psi", "u")}})
    cl, fcl = dp._prep_coeffs(dlp.coeffs), dp._flat_facet(dlp.facet_coeffs)
    x = torch.where(dp.bc_mask, dp.bc_val, torch.zeros_like(dp.bc_val))
    b = -dp._local_residual(x, cl, fcl, dict(dlp.consts), dp.bc_mask,
                            dp.bc_val)
    Av = dp._jac_operator(x, cl, fcl, dict(dlp.consts), dp.bc_mask)
    Minv = dp._asm_btlu_pc(x, cl, dict(dlp.consts), "f64")
    beta = float(torch.sqrt(dp._pdot(b, b)))

    def logged(log):
        def call(kind, fn):
            def f(v):
                v = torch.as_tensor(np.array(v))
                y = fn(v)
                log.append((kind, v.numpy(), y.numpy()))
                return y
            return f
        return call("A", Av), call("M", Minv)

    def port(rhs, its):
        log = []
        A, M = logged(log)
        return dp._gmres(A, rhs, M, 1e-11, 0.0, its, restart=120), log

    def reference(its):
        log = []
        A, M = logged(log)

        def cb(fn):
            return lambda v: jax.pure_callback(
                lambda u: np.asarray(fn(u)),
                jax.ShapeDtypeStruct(v.shape, v.dtype), v,
                vmap_method="broadcast_all")
        dx = jax.vmap(lambda r: rdp._gmres(cb(A), r, cb(M), 1e-11, 0.0, its,
                                           restart=120),
                      axis_name=rdp.axis)(jnp.asarray(b.numpy()))
        return np.asarray(dx), log

    dx_p, log_p = port(b, 150)
    dx_c, log_c = port(b * (1.0 + 2.0 ** -52), 150)
    dx_r, log_r = reference(150)
    # the first cycle's 120 Arnoldi steps: one A and one M call each
    # after the first residual's A call
    est_p, est_c, est_r = (_residual_estimates(log[:241], beta)
                           for log in (log_p, log_c, log_r))
    assert len(est_p) == len(est_c) == len(est_r) == 121
    ref_gap = np.abs(est_r - est_p) / est_p
    ulp_gap = np.abs(est_c - est_p) / est_p
    assert np.max(ref_gap[:25]) <= 1e-12
    assert ulp_gap[-1] > 1e-3
    assert np.all(np.maximum.accumulate(ref_gap) <=
                  10.0 * np.maximum.accumulate(ulp_gap) + 1e-12)
    scale = np.max(np.abs(dx_p.numpy()))
    assert np.max(np.abs(dx_r - dx_p.numpy())) <= \
        10.0 * np.max(np.abs(dx_c.numpy() - dx_p.numpy())) + 1e-12 * scale
