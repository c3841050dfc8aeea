"""The full LVPPSolver driving the port's dof-partitioned problem
(parallel/dofpart.DistributedLvppProblem) against the reference package,
on the CPU with 8 subdomains (the reference on its 8 virtual devices):
the LVPP driver of tests/test_dofpart.py (held to the reference's host
run, which that test proves equal to its distributed run), the retry
machine, the SNES reason of a solve stopped at its iteration cap, and the
line-search / block-Schur variants, each with its Newton
counts identical to the reference's distributed run. The Schwarz
variants and the asm_btlu strength case are in
test_torch_dofpart_asm.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proximalgalerkin_tpu.mesh.unstructured import \
    create_disk_mesh as ref_disk
from proximalgalerkin_tpu.models.obstacle import \
    setup_obstacle_problem as ref_setup
from proximalgalerkin_tpu.parallel.dofpart import (
    DistributedLvppProblem as RefDLP, DistributedProblem as RefDP)
from proximalgalerkin_tpu.solve import AlphaScheduler as RefScheduler
from proximalgalerkin_tpu.solve.lvpp import LVPPSolver as RefLVPP

from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
from proximalgalerkin_torch.parallel.dofpart import (
    DistributedLvppProblem, DistributedProblem)
from proximalgalerkin_torch.solve import AlphaScheduler
from proximalgalerkin_torch.solve.lvpp import LVPPSolver

ND = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """Both packages' obstacle problems on the disk at `res` and their
    distributed problems (8 subdomains / 8 virtual devices)."""

    def __init__(self, res):
        self.prob = setup_obstacle_problem(create_disk_mesh(res),
                                           polynomial_order=1,
                                           verbose=False, device="cpu")
        self.rprob = ref_setup(ref_disk(res), polynomial_order=1,
                               verbose=False)
        self.space = self.prob.space
        self.dp = DistributedProblem(self.prob.problem, n_devices=ND)
        self.rdp = RefDP(self.rprob.problem)

    def run(self, opts, ref=False, **kw):
        """The LVPP driver on the distributed problem of either package;
        returns (result, u of the gathered solution)."""
        dp = self.rdp if ref else self.dp
        q = self.rprob.problem if ref else self.prob.problem
        dlp = (RefDLP if ref else DistributedLvppProblem)(dp)
        dlp.update(coeffs={"phi": dp.scatter_cellq(
            np.asarray(q.coeffs["phi"]))})
        res = (RefLVPP if ref else LVPPSolver)(
            dlp, newton_options=dict(opts),
            alpha=kw.pop("alpha", None) or (
                RefScheduler if ref else AlphaScheduler)(
                scheme="double_exponential", alpha_max=1e5),
            prev_coeffs=lambda xs: {"psi_k": dp.field_to_coeff(xs, "psi"),
                                    "u_k": dp.field_to_coeff(xs, "u")},
            verbose=False, **kw).solve(
                dp.scatter(np.zeros(self.space.num_dofs)))
        return res, dp.gather(res.x)[self.space.slice_of("u")]


DRIVER_OPTS = {"snes_rtol": 1e-6, "snes_max_it": 50,
               "snes_linesearch_type": "none", "ksp_type": "minres",
               "pc_type": "jacobi", "mat_type": "matfree",
               "ksp_rtol": 1e-11, "ksp_max_it": 2000}


def test_lvpp_driver_distributed_matches_single_device():
    """The full LVPPSolver (alpha schedule, commit-on-converge) drives the
    distributed problem through DistributedLvppProblem and reproduces the
    reference's single-device trajectory (disk res 0.25, 4 steps):
    identical Newton counts, increments to 1e-6, x within 1e-8."""
    pair = Pair(0.25)
    space = pair.space
    psi_sl, u_sl = space.slice_of("psi"), space.slice_of("u")
    ref = RefLVPP(
        pair.rprob.problem, newton_options=dict(DRIVER_OPTS),
        alpha=RefScheduler(scheme="double_exponential", alpha_max=1e5),
        prev_coeffs=lambda x_k: {"psi_k": x_k[psi_sl], "u_k": x_k[u_sl]},
        tol=1e-50, max_iterations=4, verbose=False).solve(
            jnp.zeros(space.num_dofs))
    dist, _ = pair.run(DRIVER_OPTS, tol=1e-50, max_iterations=4)
    assert dist.newton_steps == ref.newton_steps
    assert np.allclose(dist.increments, ref.increments, rtol=1e-6)
    x_d = pair.dp.gather(dist.x)
    assert np.max(np.abs(x_d - np.asarray(ref.x))) < 1e-8


def test_lvpp_driver_distributed_retry_machine():
    """The adaptive failure-retry machine (fracture_dolfinx.py:220-264)
    on shards: alpha = 64 with a 2-iteration Newton budget fails, halves
    and retries; the trajectory (Newton counts, LVPP iterations) equals
    the reference's distributed one and the iterate stays finite."""
    pair = Pair(0.3)
    opts = {"snes_rtol": 1e-6, "snes_max_it": 2,
            "snes_linesearch_type": "none", "ksp_type": "minres",
            "pc_type": "jacobi", "ksp_rtol": 1e-11, "ksp_max_it": 2000}
    kw = dict(tol=1e-5, max_iterations=12, adaptive=True, nfail_max=20)
    res, _ = pair.run(opts, alpha=AlphaScheduler(scheme="constant", C=64.0),
                      **kw)
    ref, _ = pair.run(opts, ref=True,
                      alpha=RefScheduler(scheme="constant", C=64.0), **kw)
    assert res.iterations > 0
    assert all(n <= 2 for n in res.newton_steps)
    assert np.isfinite(pair.dp.gather(res.x)).all()
    assert (res.newton_steps, res.iterations, res.converged) == \
        (ref.newton_steps, ref.iterations, ref.converged)
    assert np.allclose(res.increments, ref.increments, rtol=1e-6)


@pytest.fixture(scope="module")
def capped_start():
    """The port's distributed problem on the disk at res 0.3 (8
    subdomains) at the first LVPP step's point (alpha 1, zero latent)."""
    prob = setup_obstacle_problem(create_disk_mesh(0.3), polynomial_order=1,
                                  verbose=False, device="cpu")
    dp = DistributedProblem(prob.problem, n_devices=ND)
    dlp = DistributedLvppProblem(dp)
    xs = dp.scatter(np.zeros(prob.space.num_dofs))
    dlp.update(coeffs={"phi": dp.scatter_cellq(
        np.asarray(prob.problem.coeffs["phi"])),
        "psi_k": dp.field_to_coeff(xs, "psi"),
        "u_k": dp.field_to_coeff(xs, "u")},
        consts={"alpha": torch.tensor(1.0, dtype=torch.float64)})
    return dlp, xs


@pytest.mark.parametrize("error_if_not_converged", [False, True])
def test_distributed_newton_reason_at_its_cap(capped_start,
                                              error_if_not_converged):
    """A distributed Newton solve capped at snes_max_it=1 (this start
    takes several steps to converge) stops with DIVERGED_MAX_IT after its
    one step, with its residual reduced; with snes_error_if_not_converged
    it raises NotConvergedError with that reason instead."""
    from proximalgalerkin_torch.core.reasons import (ConvergedReason,
                                                     NotConvergedError)
    dlp, xs = capped_start
    newton = dlp.make_newton_solver(dict(
        DRIVER_OPTS, snes_max_it=1,
        snes_error_if_not_converged=error_if_not_converged))
    if error_if_not_converged:
        with pytest.raises(NotConvergedError) as err:
            newton.solve(xs)
        assert err.value.reason == ConvergedReason.DIVERGED_MAX_IT
        return
    res = newton.solve(xs)
    assert res.reason == ConvergedReason.DIVERGED_MAX_IT
    assert not res.converged
    assert res.iterations == 1
    f0, fn = res.fnorm_history
    assert np.isfinite(fn) and fn < f0


VARIANTS = {
    "none/jacobi": {},
    "bt/jacobi": {"snes_linesearch_type": "bt"},
    "l2/jacobi": {"snes_linesearch_type": "l2"},
    "none/schur": {"pc_type": "schur", "pc_schur_field0": "psi"},
    # the host direct default maps to restricted additive Schwarz with a
    # dense subdomain LU under right-preconditioned GMRES
    "preonly/asm_lu": {"pc_type": "lu", "ksp_type": "preonly"},
    # block-tridiagonal RAS subdomain factor (asm_btlu)
    "preonly/asm_btlu": {"pc_type": "btlu", "ksp_type": "preonly"},
}
# the Schwarz variants run in tests/test_torch_dofpart_asm.py
HERE = ("none/jacobi", "bt/jacobi", "l2/jacobi", "none/schur")
# LVPP steps held: the reference test's 3, except the matrix-free Schur
# variant's first step (6 of its 12 Newton steps): each MINRES iteration
# applies 9 eager jvp actions, 65 s for the 3 steps on this CPU
STEPS = {"none/schur": 1}
VARIANT_OPTS = {"snes_rtol": 1e-6, "snes_max_it": 50,
                "snes_linesearch_type": "none", "ksp_type": "minres",
                "pc_type": "jacobi", "ksp_rtol": 1e-11, "ksp_max_it": 3000}


@pytest.fixture(scope="module")
def variants():
    """Disk res 0.3, 3 LVPP steps of each variant, both packages,
    computed on first use."""
    pair = Pair(0.3)
    cache = {}

    def get(tag, ref=False, steps=3):
        if (tag, ref, steps) not in cache:
            cache[tag, ref, steps] = pair.run(
                dict(VARIANT_OPTS, **VARIANTS[tag]), ref=ref, tol=1e-50,
                max_iterations=steps)
        return cache[tag, ref, steps]

    return get


def check_variant(variants, tag):
    """bt/l2 line searches, the matrix-free block-Schur PC and the two
    Schwarz PCs converge on shards with the reference's distributed
    Newton counts, and agree with the plain damped/jacobi solution to
    1e-6 (the reference test's bound)."""
    steps = STEPS.get(tag, 3)
    res, u = variants(tag, steps=steps)
    ref, u_ref = variants(tag, ref=True, steps=steps)
    assert all(n > 0 for n in res.newton_steps), tag
    assert res.newton_steps == ref.newton_steps, tag
    assert np.max(np.abs(u - u_ref)) < 1e-6
    _, base = variants("none/jacobi", steps=steps)
    assert np.max(np.abs(u - base)) < 1e-6, tag


@pytest.mark.parametrize("tag", HERE)
def test_distributed_linesearch_and_schur_variants(variants, tag):
    check_variant(variants, tag)
