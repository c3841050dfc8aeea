"""The port's Signorini contact (models/signorini.py, solve/composite.py)
against the reference's, on the CPU: the seven cases of
tests/test_signorini.py in both packages — the half-disk and half-sphere
meshes bit-identical, LVPP and per-step Newton counts identical, u and
psi within 1e-10, penetrations and the per-cell von Mises stress within
1e-10 — with the reference test's own checks on the port's solutions; the
composite problem's residual and Jacobian against the JAX package's, its
matrix-free action against its assembled matrix, and its refusal of a
Krylov direction; and the signorini CLI."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proximalgalerkin_tpu.mesh import parametric as ref_parametric
from proximalgalerkin_tpu.models import signorini as ref_mod

from proximalgalerkin_torch.mesh.parametric import (create_half_disk,
                                                    create_half_sphere)
from proximalgalerkin_torch.models import signorini as mod

KW2 = dict(res=0.06, disp=-0.10, verbose=False, max_iterations=20)
KW3 = dict(disp=-0.10, gap=0.02, verbose=False, max_iterations=20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    return (mod.solve_signorini(device="cpu", **KW2),
            ref_mod.solve_signorini(**KW2))


@pytest.fixture(scope="module")
def solved_3d():
    return (mod.solve_signorini(tagged=create_half_sphere(res=0.16),
                                device="cpu", **KW3),
            ref_mod.solve_signorini(
                tagged=ref_parametric.create_half_sphere(res=0.16), **KW3))


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _same(r, rr):
    assert r.lvpp_iterations == rr.lvpp_iterations
    assert r.newton_iterations == rr.newton_iterations
    assert r.converged == rr.converged
    assert _rel(r.u, rr.u) <= 1e-10
    assert _rel(r.psi, rr.psi) <= 1e-10
    assert _rel(r.penetrations, rr.penetrations) <= 1e-10
    assert _rel(r.von_mises, rr.von_mises) <= 1e-10


# ------------------------------------ the reference test's cases, ported


def test_half_disk_mesh():
    tm = create_half_disk(res=0.05)
    rtm = ref_parametric.create_half_disk(res=0.05)
    np.testing.assert_array_equal(tm.mesh.points, rtm.mesh.points)
    np.testing.assert_array_equal(tm.mesh.cells, rtm.mesh.cells)
    for name in ("contact", "displacement"):
        np.testing.assert_array_equal(tm.facets(name), rtm.facets(name))
    assert len(tm.facets("contact")) > 10
    assert len(tm.facets("displacement")) > 2
    m = tm.mesh
    pts = m.points[m.cell_vertices]
    v1, v2 = pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0]
    area = 0.5 * np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]).sum()
    assert abs(area - np.pi * 0.25 / 2) < 0.01


def test_converges(solved):
    r, rr = solved
    _same(r, rr)
    assert r.converged
    assert r.lvpp_iterations <= 20
    assert sum(r.newton_iterations) < 60


def test_no_penetration(solved):
    """Displaced body must not penetrate the rigid plane y = gap beyond
    the LVPP tolerance."""
    r, _ = solved
    assert r.penetrations[-1] < 1e-3
    assert r.u[:, 1].min() >= -0.1 - 1e-9


def test_dirichlet_applied(solved):
    r, _ = solved
    assert np.isclose(r.u[:, 1].min(), -0.1)


def test_contact_pressure_sign(solved):
    """Latent psi finite and contact active (exp(psi) small where
    touching)."""
    r, _ = solved
    assert np.isfinite(r.psi).all()
    assert r.psi.min() < -1.0


def test_half_sphere_mesh_3d():
    tm = create_half_sphere(res=0.14)
    rtm = ref_parametric.create_half_sphere(res=0.14)
    np.testing.assert_array_equal(tm.mesh.points, rtm.mesh.points)
    np.testing.assert_array_equal(tm.mesh.cells, rtm.mesh.cells)
    for name in ("contact", "displacement"):
        np.testing.assert_array_equal(tm.facets(name), rtm.facets(name))
    m = tm.mesh
    assert m.cell_type == "tetrahedron" and m.gdim == 3
    assert len(tm.facets("contact")) > 20
    assert len(tm.facets("displacement")) > 10
    p = m.points[m.cell_vertices]
    vol = np.abs(np.einsum("ij,ij->i",
                           np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
                           p[:, 3] - p[:, 0])).sum() / 6
    assert abs(vol - 2 * np.pi * 0.5**3 / 3) < 0.04


def test_signorini_3d(solved_3d):
    r, rr = solved_3d
    _same(r, rr)
    assert r.converged
    assert r.penetrations[-1] < 5e-3
    assert np.isclose(r.u[:, 2].min(), -0.1)


# -------------------------------------------------- the composite problem


def _composite(pkg, tm, iterative=False):
    """The Signorini composite problem of one package on tm, through its
    solve_signorini with the Newton solve replaced by a capture."""
    m = mod if pkg == "torch" else ref_mod
    captured = {}

    class Capture(Exception):
        pass

    def solve(self, x0):
        captured["problem"] = self.problem
        captured["x0"] = x0
        raise Capture

    kw = {"device": "cpu"} if pkg == "torch" else {}
    opts = ({"ksp_type": "minres", "pc_type": "jacobi"} if iterative
            else None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(m.NewtonSolver, "solve", solve)
        with pytest.raises(Capture):
            m.solve_signorini(tagged=tm, verbose=False, solver_options=opts,
                              **kw)
    return captured["problem"]


@pytest.mark.parametrize("iterative", [False, True])
def test_composite_matches_reference(iterative):
    p = _composite("torch", create_half_disk(res=0.08), iterative)
    rp = _composite("jax", ref_parametric.create_half_disk(res=0.08),
                    iterative)
    rng = np.random.default_rng(1)
    n = p.space.num_dofs
    x = rng.standard_normal(n) * 0.05
    psi_k = rng.standard_normal(tuple(p.facet_forms[0].facet_data[
        "wdet"].shape)) * 0.1
    for prob, xp in ((p, torch), (rp, jnp)):
        prob.update(facet_coeffs={"psi_k": xp.asarray(psi_k)},
                    consts={"alpha": xp.asarray(0.04, dtype=xp.float64)})
    np.testing.assert_array_equal(p._bc_idx_host, np.asarray(rp.bc_idx))
    xb = p.set_bc(x)
    np.testing.assert_array_equal(xb.numpy(),
                                  np.asarray(rp.set_bc(jnp.asarray(x))))
    F, rF = p.residual(xb).numpy(), np.asarray(rp.residual(
        jnp.asarray(xb.numpy())))
    assert _rel(F, rF) <= 1e-12
    A = p.jacobian_scipy(xb)
    rA = rp.jacobian_scipy(jnp.asarray(xb.numpy()))
    assert abs(A - rA).max() <= 1e-12 * abs(rA).max()
    # the matrix-free action: the jvp of the Jacobian residuals (with the
    # eps-mass term when iterative), with the symmetric bc treatment
    v = rng.standard_normal(n)
    Av = p.jacobian_action(xb)(torch.as_tensor(v)).numpy()
    rAv = np.asarray(rp.jacobian_action(jnp.asarray(xb.numpy()))(
        jnp.asarray(v)))
    assert _rel(Av, rAv) <= 1e-12
    assert _rel(Av, A @ v) <= 1e-12
    np.testing.assert_allclose(p.jacobian_diagonal(xb).numpy(), A.diagonal(),
                               rtol=0, atol=0)


def test_krylov_direction_refused():
    """The reference composite has no device direction (its NewtonSolver
    raises AttributeError); the port's names the distributed slice."""
    with pytest.raises(NotImplementedError, match="A12"):
        mod.solve_signorini(res=0.1, verbose=False, max_iterations=1,
                            solver_options={"ksp_type": "minres",
                                            "pc_type": "jacobi"},
                            device="cpu")


def test_cli(capsys):
    from proximalgalerkin_torch.cli import main
    main(["signorini", "--res", "0.1", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    r = mod.solve_signorini(res=0.1, verbose=False, device="cpu")
    assert out == (f"LVPP {r.lvpp_iterations}, Newton "
                   f"{sum(r.newton_iterations)}, final penetration "
                   f"{r.penetrations[-1]:.3e}")
