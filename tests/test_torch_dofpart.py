"""The port's dof-partitioned FEM (parallel/dofpart.py) against the
reference package's, on the CPU, with 8 subdomains on the port's shard
axis and the reference on its 8 virtual CPU devices (tests/conftest.py):
the host partition (strip-ordered cells, first-touch field partitions,
rewritten gathers, BC masks, io maps) bit-identical; residual, Jacobian
action and diagonal within 1e-12 of the reference's distributed values
and of the port's single-device ones; the fused distributed Newton of
tests/test_dofpart.py with its counts identical; the Signorini composite
(volume + contact facet leg on a trace space): its partition, residual
and Jacobian action, and its Newton trajectory on 8 subdomains == 1 ==
the reference's host-LU counts. The LVPP-driver cases are in
test_torch_dofpart_lvpp.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proximalgalerkin_tpu.core.config import SolverOptions as RefOptions
from proximalgalerkin_tpu.mesh import rectangle_mesh as ref_rectangle
from proximalgalerkin_tpu.mesh.unstructured import \
    create_disk_mesh as ref_disk
from proximalgalerkin_tpu.models.obstacle import \
    setup_obstacle_problem as ref_setup
from proximalgalerkin_tpu.parallel.dofpart import \
    DistributedProblem as RefDP
from proximalgalerkin_tpu.solve import AlphaScheduler as RefScheduler
from proximalgalerkin_tpu.solve.newton import NewtonSolver as RefNewton

from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
from proximalgalerkin_torch.parallel.dofpart import DistributedProblem
from proximalgalerkin_torch.solve import AlphaScheduler

ND = 8
f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = {
    "rect13x11_P2": (lambda: rectangle_mesh(13, 11, p0=(-1.0, -1.0),
                                            p1=(1.0, 1.0)),
                     lambda: ref_rectangle(13, 11, p0=(-1.0, -1.0),
                                           p1=(1.0, 1.0)), 2),
    "disk0.2_P1": (lambda: create_disk_mesh(0.2), lambda: ref_disk(0.2), 1),
}


def _setup(name):
    """Both packages' obstacle problems on the same mesh, with the
    reference test's random state (seed 7) as coefficients."""
    mk, mk_ref, order = MESHES[name]
    prob = setup_obstacle_problem(mk(), polynomial_order=order,
                                  verbose=False, device="cpu")
    rprob = ref_setup(mk_ref(), polynomial_order=order, verbose=False)
    space = prob.space
    rng = np.random.default_rng(7)
    x = rng.standard_normal(space.num_dofs)
    psi_k = rng.standard_normal(space.spaces["psi"].num_dofs)
    u_k = rng.standard_normal(space.spaces["u"].num_dofs)
    prob.problem.update(coeffs={"psi_k": torch.as_tensor(psi_k),
                                "u_k": torch.as_tensor(u_k)})
    rprob.problem.update(coeffs={"psi_k": jnp.asarray(psi_k),
                                 "u_k": jnp.asarray(u_k)})
    return prob.problem, rprob.problem, space, x, psi_k, u_k


def _dist_coeffs(dp, p, psi_k, u_k):
    return {"phi": dp.scatter_cellq(np.asarray(p.coeffs["phi"])),
            "psi_k": dp.scatter_coeff("psi_k", psi_k),
            "u_k": dp.scatter_coeff("u_k", u_k)}


def _rel(a, ref):
    return float(np.max(np.abs(a - ref))) / max(1.0, float(
        np.max(np.abs(ref))))


def _same_partition(dp, rdp):
    """Every host array of the two partitions equal, bit for bit."""
    assert dp.nd == rdp.nd == ND
    np.testing.assert_array_equal(dp.ordered_cells, rdp.ordered_cells)
    np.testing.assert_array_equal(dp.cell_pad, rdp.cell_pad)
    assert dp.cpd == rdp.cpd
    for parts, rparts in ((dp.parts, rdp.parts),
                          (dp.coeff_parts, rdp.coeff_parts)):
        assert list(parts) == list(rparts)
        for f in parts:
            a, b = parts[f], rparts[f]
            np.testing.assert_array_equal(a.new_of_old, b.new_of_old)
            assert (a.Bs, a.m, a.k, a.B, a.ext_size) == \
                (b.Bs, b.m, b.k, b.B, b.ext_size)
    assert dp.coeff_shared_field == rdp.coeff_shared_field
    assert (dp.loc_off, dp.Bsum, dp.ext_off, dp.ext_total) == \
        (rdp.loc_off, rdp.Bsum, rdp.ext_off, rdp.ext_total)
    for f, g in dp._gather_host.items():
        ref = np.asarray(rdp.data_loc["gather_idx"][f])
        assert g.dtype == ref.dtype
        np.testing.assert_array_equal(g, ref)
    for n, g in dp._coeff_gather_host.items():
        np.testing.assert_array_equal(
            g, np.asarray(rdp.data_loc["coeff_idx"][n]))
    np.testing.assert_array_equal(dp._dest, rdp._dest)
    np.testing.assert_array_equal(dp._bc_mask_host,
                                  np.asarray(rdp.bc_mask).reshape(ND, -1))
    np.testing.assert_array_equal(
        dp.bc_val.numpy(), np.asarray(rdp.bc_val).reshape(ND, -1))
    for meta, rmeta in zip(dp._facet_meta, rdp._facet_meta):
        np.testing.assert_array_equal(meta["sel"], rmeta["sel"])
        np.testing.assert_array_equal(meta["valid"], rmeta["valid"])
        assert meta["fpd"] == rmeta["fpd"]
    for fg, rfd in zip(dp._facet_gather_host, rdp.facet_data_loc):
        for f, g in fg.items():
            np.testing.assert_array_equal(
                g, np.asarray(rfd["gather_idx"][f]))


@pytest.mark.parametrize("name", list(MESHES))
def test_host_partition_bit_identical(name):
    p, rp, _, _, _, _ = _setup(name)
    _same_partition(DistributedProblem(p, n_devices=ND), RefDP(rp))


@pytest.mark.parametrize("name", list(MESHES))
def test_residual_and_jacobian_match(name):
    """The reference test's residual and Jacobian action against the
    port's single-device values and the reference's distributed ones,
    within 1e-12 relative; the Jacobi diagonal likewise."""
    p, rp, space, x, psi_k, u_k = _setup(name)
    dp, rdp = DistributedProblem(p, n_devices=ND), RefDP(rp)
    F_one = p.residual(torch.as_tensor(x)).numpy()
    xs, rxs = dp.scatter(x), rdp.scatter(x)
    coeffs = _dist_coeffs(dp, p, psi_k, u_k)
    rcoeffs = _dist_coeffs(rdp, rp, psi_k, u_k)
    F_d = dp.gather(dp.residual(xs, coeffs))
    assert _rel(F_d, F_one) < 1e-12
    assert _rel(F_d, rdp.gather(rdp.residual(rxs, rcoeffs))) < 1e-12

    v = np.random.default_rng(3).standard_normal(space.num_dofs)
    Jv_one = p.jacobian_action(torch.as_tensor(x))(
        torch.as_tensor(v)).numpy()
    Jv_d = dp.gather(dp.jacobian_action(xs, dp.scatter(v), coeffs))
    assert _rel(Jv_d, Jv_one) < 1e-12
    assert _rel(Jv_d, rdp.gather(rdp.jacobian_action(
        rxs, rdp.scatter(v), rcoeffs))) < 1e-12
    d_one = p.jacobian_diagonal(torch.as_tensor(x)).numpy()
    d_d = dp._local_diagonal(xs, dp._prep_coeffs(coeffs), {},
                             dict(dp.consts), dp.bc_mask)
    assert _rel(dp.gather(d_d), d_one) < 1e-12


def test_scatter_gather_roundtrip_and_memory():
    p, rp, space, x, _, _ = _setup("disk0.2_P1")
    dp, rdp = DistributedProblem(p, n_devices=ND), RefDP(rp)
    np.testing.assert_array_equal(dp.gather(dp.scatter(x)), x)
    # the layout of the shards is the reference's flat sharded vector
    np.testing.assert_array_equal(dp.scatter(x).numpy().reshape(-1),
                                  np.asarray(rdp.scatter(x)))
    c = np.arange(space.spaces["psi"].num_dofs, dtype=float)
    np.testing.assert_array_equal(
        dp.scatter_coeff("psi_k", c).numpy().reshape(-1),
        np.asarray(rdp.scatter_coeff("psi_k", c)))
    np.testing.assert_array_equal(
        dp.field_to_coeff(dp.scatter(x), "psi").numpy().reshape(-1),
        np.asarray(rdp.field_to_coeff(rdp.scatter(x), "psi")))
    # per-subdomain dof state is O(N / nd): owned blocks only (plus <=
    # nd-1 pad dofs per field)
    N = space.num_dofs
    assert dp.Bsum <= N / dp.nd + 2 * dp.nd * len(space.names)
    assert dp.per_device_dof_memory() == rdp.per_device_dof_memory()
    # halos ride a +-1 ring on strip-ordered meshes
    assert all(dp.parts[f].k <= 2 for f in space.names)


NEWTON_OPTS = {
    "snes_rtol": 1e-6, "snes_max_it": 50, "snes_linesearch_type": "none",
    "ksp_type": "minres", "pc_type": "jacobi", "mat_type": "matfree",
    "ksp_rtol": 1e-11, "ksp_atol": 0.0, "ksp_max_it": 2000}


def _host_lvpp(p, space, solver, options, scheduler, to_x, steps=3):
    """The reference test's host loop: Newton counts and x of `steps`
    LVPP steps of either package."""
    psi_sl, u_sl = space.slice_of("psi"), space.slice_of("u")
    sched = scheduler(scheme="double_exponential", alpha_max=1e5)
    x = to_x(np.zeros(space.num_dofs))
    its = []
    for k in range(steps):
        p.update(coeffs={"psi_k": x[psi_sl], "u_k": x[u_sl]},
                 consts={"alpha": to_x(sched.value(k))})
        res = solver(p, options(NEWTON_OPTS)).solve(x)
        assert res.converged
        x = res.x
        its.append(res.iterations)
    return its, np.asarray(x)


def test_fused_newton_lvpp_matches_single_device():
    """The distributed Newton (fused_lvpp_newton, minres/jacobi)
    reproduces the single-device host-loop LVPP trajectory of
    tests/test_dofpart.py (disk res 0.25, 3 steps): Newton counts
    identical to the reference's host run and its distributed
    newton_solver's, x within 1e-10 of the reference's host run."""
    prob = setup_obstacle_problem(create_disk_mesh(0.25), polynomial_order=1,
                                  verbose=False, device="cpu")
    rprob = ref_setup(ref_disk(0.25), polynomial_order=1, verbose=False)
    p, rp, space = prob.problem, rprob.problem, prob.space
    its_ref, x_ref = _host_lvpp(rp, space, RefNewton, RefOptions,
                                RefScheduler, jnp.asarray)

    def run(dp, alpha):
        if isinstance(dp, RefDP):
            newton = dp.newton_solver(ksp="minres", rtol=1e-6, max_it=50,
                                      ksp_rtol=1e-11, ksp_max_it=2000)
        else:
            fused = dp.fused_lvpp_newton(ksp="minres", pc="jacobi",
                                         max_it=50, ksp_max_it=2000)

            def newton(xs, coeffs, consts):
                return fused(xs, coeffs, consts, rtol=1e-6,
                             ksp_rtol=1e-11)[:4]
        q = dp.problem
        phi = dp.scatter_cellq(np.asarray(q.coeffs["phi"]))
        sched = AlphaScheduler(scheme="double_exponential", alpha_max=1e5)
        xs = dp.scatter(np.zeros(space.num_dofs))
        its = []
        for k in range(3):
            coeffs = {"phi": phi, "psi_k": dp.field_to_coeff(xs, "psi"),
                      "u_k": dp.field_to_coeff(xs, "u")}
            xs, nit, _, _ = newton(xs, coeffs, {"alpha": alpha(
                sched.value(k))})
            its.append(int(nit))
        return its, dp.gather(xs)

    its_d, x_d = run(DistributedProblem(p, n_devices=ND),
                     lambda a: torch.tensor(a, dtype=f64))
    its_rd, _ = run(RefDP(rp), jnp.asarray)
    assert its_d == its_rd == its_ref
    assert np.max(np.abs(x_d - x_ref)) < 1e-10


# ------------------------------------------------------------ Signorini

def _signorini_pair(res=0.05):
    """The reference test's small Signorini composite (volume elasticity
    + contact facet leg with a TraceSpace latent) in both packages."""
    from proximalgalerkin_tpu.assembly import VolumeForm as RVF
    from proximalgalerkin_tpu.assembly.facets import FacetForm as RFF
    from proximalgalerkin_tpu.mesh.parametric import \
        create_half_disk as r_half
    from proximalgalerkin_tpu.solve.composite import CompositeProblem as RCP
    from proximalgalerkin_tpu.spaces import (DirichletBC as RBC,
                                             FunctionSpace as RFS,
                                             MixedSpace as RMS)
    from proximalgalerkin_tpu.spaces.trace import TraceSpace as RTS

    from proximalgalerkin_torch.assembly import VolumeForm
    from proximalgalerkin_torch.assembly.facets import FacetForm
    from proximalgalerkin_torch.mesh.parametric import create_half_disk
    from proximalgalerkin_torch.solve.composite import CompositeProblem
    from proximalgalerkin_torch.spaces import (DirichletBC, FunctionSpace,
                                               MixedSpace)
    from proximalgalerkin_torch.spaces.trace import TraceSpace

    E, nu, gap = 2e4, 0.3, 0.02
    mu = E / (2 * (1 + nu))
    lmbda = E * nu / ((1 + nu) * (1 - 2 * nu))

    def build(half, FS, TS, MS, VF, FF, BC, CP, alpha, xp):
        tagged = half(res=res)
        mesh = tagged.mesh
        gdim = mesh.gdim
        contact = tagged.facets("contact")
        disp_f = tagged.facets("displacement")
        kw = {} if xp is jnp else {"device": "cpu"}
        Vu = FS.create(mesh, 1, value_size=gdim)
        trace = TS(FS.create(mesh, 1), contact)
        space_vol = MS([("u", Vu)])
        space_all = MS([("u", Vu), ("psi", trace)])
        n_g = np.zeros(gdim)
        n_g[-1] = -1.0
        if xp is jnp:
            n_g_x, eye = jnp.asarray(n_g), jnp.eye(gdim)
            dot, tr = jnp.dot, jnp.trace
            exp_c = lambda p: jnp.exp(jnp.minimum(p, 45.0))
        else:
            n_g_x, eye = torch.as_tensor(n_g), torch.eye(gdim, dtype=f64)
            dot, tr = torch.dot, torch.trace
            exp_c = lambda p: torch.exp(torch.clamp(p, max=45.0))

        def vol_residual(x, u, gu, c, gc, consts):
            eps_u = 0.5 * (gu["u"] + gu["u"].T)
            sigma = 2 * mu * eps_u + lmbda * tr(eps_u) * eye
            return {"u": (None, consts["alpha"] * sigma)}

        def facet_residual(x, u, gu, c, gc, n, consts):
            g = x[gdim - 1] - gap
            un = dot(u["u"], n_g_x)
            return {"u": -(u["psi"] - c["psi_k"]) * n_g_x,
                    "psi": -(un + exp_c(u["psi"]) - g)}

        def facet_jacobian(x, u, gu, c, gc, n, consts):
            out = facet_residual(x, u, gu, c, gc, n, consts)
            out["psi"] = out["psi"] - 1e-8 * u["psi"]
            return out

        vol_form = VF(space_vol, vol_residual, 4, **kw)
        facet_form = FF(space_all, contact, facet_residual, 4,
                        jacobian_fn=facet_jacobian, **kw)
        disp_dofs = Vu.facet_closure_dofs(disp_f)
        disp_vals = np.zeros(len(disp_dofs))
        disp_vals[np.asarray(disp_dofs) % gdim == gdim - 1] = -0.1
        bcs = [BC("u", disp_dofs, disp_vals)]
        p = CP(space_all, vol_form, [facet_form], bcs,
               consts={"alpha": alpha(0.005)})
        return p, space_all, facet_form

    ours = build(create_half_disk, FunctionSpace, TraceSpace, MixedSpace,
                 VolumeForm, FacetForm, DirichletBC, CompositeProblem,
                 lambda a: torch.tensor(a, dtype=f64), torch)
    ref = build(r_half, RFS, RTS, RMS, RVF, RFF, RBC, RCP, jnp.asarray, jnp)
    return ours, ref


@pytest.fixture(scope="module")
def signorini():
    return _signorini_pair()


def test_signorini_composite_partition_residual_jacobian(signorini):
    """The composite's partition (facet legs owned by their parent cell's
    subdomain, the trace field touched only by them) bit-identical; its
    residual and Jacobian action within 1e-12 of the reference's
    distributed values and of the port's assembled host matrix."""
    (p, space, ff), (rp, _, rff) = signorini
    dp, rdp = DistributedProblem(p, n_devices=ND), RefDP(rp)
    _same_partition(dp, rdp)
    N = space.num_dofs
    rng = np.random.default_rng(0)
    x = rng.standard_normal(N) * 0.01
    nfac, nq = ff.facet_data["wdet"].shape
    psi_k_q = rng.standard_normal((nfac, nq)) * 0.01
    p.update(facet_coeffs={"psi_k": torch.as_tensor(psi_k_q)})
    F_one = p.residual(torch.as_tensor(x)).numpy()
    xs, rxs = dp.scatter(x), rdp.scatter(x)
    fc = {"psi_k": dp.scatter_facetq(psi_k_q)}
    rfc = {"psi_k": rdp.scatter_facetq(psi_k_q)}
    F_d = dp.gather(dp.residual(xs, facet_coeffs=fc))
    assert _rel(F_d, F_one) < 1e-12
    assert _rel(F_d, rdp.gather(rdp.residual(rxs, facet_coeffs=rfc))) \
        < 1e-12
    A = p.jacobian_scipy(torch.as_tensor(x))
    v = rng.standard_normal(N)
    Jv_d = dp.gather(dp.jacobian_action(xs, dp.scatter(v), facet_coeffs=fc))
    assert _rel(Jv_d, A @ v) < 1e-10
    assert _rel(Jv_d, rdp.gather(rdp.jacobian_action(
        rxs, rdp.scatter(v), facet_coeffs=rfc))) < 1e-12


def test_signorini_composite_newton_partition_independent(signorini):
    """The distributed Newton on the composite Signorini system is
    partition-independent (8 subdomains == 1) and follows the reference's
    host-LU trajectory (identical Newton counts over 2 LVPP steps; the
    reference test proves its own 8-device run equal to it)."""
    from proximalgalerkin_tpu.core.config import SolverOptions as RO
    from proximalgalerkin_tpu.solve.newton import NewtonSolver as RN

    (p, space, ff), (rp, _, rff) = signorini
    tab_psi = ff.facet_data["tab"]["psi"].numpy()
    gidx_psi = ff._gather_host["psi"]

    def psi_k_quad(x_k):
        return np.einsum("nqi,ni->nq", tab_psi,
                         np.asarray(x_k)[gidx_psi[:, :, 0]])

    xh = jnp.asarray(space.zeros())
    alpha = 0.005
    its_ref = []
    for k in range(2):
        rp.update(facet_coeffs={"psi_k": jnp.asarray(psi_k_quad(xh))},
                  consts={"alpha": jnp.asarray(alpha)})
        r = RN(rp, RO({"snes_linesearch_type": "none", "snes_rtol": 1e-6,
                       "snes_atol": 1e-50, "snes_max_it": 50,
                       "ksp_type": "preonly", "pc_type": "lu"})).solve(xh)
        assert r.converged
        xh = r.x
        its_ref.append(r.iterations)
        alpha *= 2
    x_ref = np.asarray(xh)

    def run_dist(dpx):
        fused = dpx.fused_lvpp_newton(ksp="minres", pc="jacobi", max_it=50,
                                      ksp_max_it=8000)

        def newton_d(xs, facet_coeffs, consts):
            return fused(xs, consts=consts, facet_coeffs=facet_coeffs,
                         rtol=1e-6, ksp_rtol=1e-12)[:4]
        xs = dpx.scatter(space.zeros())
        a = 0.005
        its = []
        for k in range(2):
            fc = {"psi_k": dpx.scatter_facetq(psi_k_quad(dpx.gather(xs)))}
            xs, nit, _, _ = newton_d(xs, facet_coeffs=fc, consts={
                "alpha": torch.tensor(a, dtype=f64)})
            its.append(int(nit))
            a *= 2
        return dpx.gather(xs), its

    x8, its8 = run_dist(DistributedProblem(p, n_devices=ND))
    x1, its1 = run_dist(DistributedProblem(p, n_devices=1))
    assert its8 == its1 == its_ref
    assert np.abs(x8 - x1).max() < 1e-9
    assert np.abs(x8 - x_ref).max() < 1e-5
