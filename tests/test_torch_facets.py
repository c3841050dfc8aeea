"""The port's facet (ds) assembler (assembly/facets.py) and trace space
(spaces/trace.py) against the reference's, on the CPU: the five cases of
tests/test_facets.py in the port; the residual, element matrices (also
through a jacobian_fn) and a functional of a Signorini-like form on the
half-disk and the half-sphere against the JAX package's at 1e-12; the
local indices equal; and TraceSpace's dofmap, sub_to_parent and
dof_points bit-identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proximalgalerkin_tpu.assembly.facets import FacetForm as RefFacetForm
from proximalgalerkin_tpu.mesh import parametric as ref_parametric
from proximalgalerkin_tpu.spaces import FunctionSpace as RefFunctionSpace
from proximalgalerkin_tpu.spaces import MixedSpace as RefMixedSpace
from proximalgalerkin_tpu.spaces.trace import TraceSpace as RefTraceSpace

from proximalgalerkin_torch.assembly.facets import FacetForm
from proximalgalerkin_torch.mesh import (parametric, unit_cube_mesh,
                                         unit_square_mesh)
from proximalgalerkin_torch.spaces import FunctionSpace, MixedSpace
from proximalgalerkin_torch.spaces.trace import TraceSpace

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------ the reference test's cases, ported


def test_boundary_measure_square():
    mesh = unit_square_mesh(5, 5)
    V = FunctionSpace.create(mesh, 1)
    space = MixedSpace([("u", V)])
    ff = FacetForm(space, mesh.exterior_facets,
                   lambda x, u, gu, c, gc, n, k: {}, 2, device=CPU)
    one = ff.make_functional(lambda x, u, gu, c, gc, n, k: 1.0)
    assert np.isclose(float(one(space.zeros())), 4.0)


def test_boundary_measure_cube():
    mesh = unit_cube_mesh(2, 2, 2)
    V = FunctionSpace.create(mesh, 1)
    space = MixedSpace([("u", V)])
    ff = FacetForm(space, mesh.exterior_facets,
                   lambda x, u, gu, c, gc, n, k: {}, 2, device=CPU)
    one = ff.make_functional(lambda x, u, gu, c, gc, n, k: 1.0)
    assert np.isclose(float(one(space.zeros())), 6.0)


def test_divergence_theorem():
    """∫_Ω div(F) dx = ∫_∂Ω F·n ds for F = (x^2, xy): checks normals and
    surface measures jointly."""
    mesh = unit_square_mesh(6, 6)
    V = FunctionSpace.create(mesh, 2)
    space = MixedSpace([("u", V)])
    ff = FacetForm(space, mesh.exterior_facets,
                   lambda x, u, gu, c, gc, n, k: {}, 6, device=CPU)
    flux = ff.make_functional(
        lambda x, u, gu, c, gc, n, k:
        x[0] ** 2 * n[0] + x[0] * x[1] * n[1])
    # div F = 2x + x = 3x, ∫ = 3/2
    assert np.isclose(float(flux(space.zeros())), 1.5, atol=1e-12)


def test_facet_residual_assembles_boundary_mass():
    """F(v) = ∫ u v ds with u = 1 gives the boundary 'mass' vector whose
    sum is the perimeter."""
    mesh = unit_square_mesh(4, 4)
    V = FunctionSpace.create(mesh, 1)
    space = MixedSpace([("u", V)])
    ff = FacetForm(space, mesh.exterior_facets,
                   lambda x, u, gu, c, gc, n, k: {"u": u["u"]}, 4,
                   device=CPU)
    z = torch.ones(space.num_dofs, dtype=torch.float64)
    F = ff.residual(z)
    assert np.isclose(float(torch.sum(F)), 4.0)
    # interior dofs receive nothing
    bdofs = set(np.asarray(V.boundary_dofs()).tolist())
    inner = [i for i in range(V.num_dofs) if i not in bdofs]
    assert np.allclose(F.numpy()[inner], 0.0)


def test_facet_gradient_tangential():
    """Boundary functional using grad(u): ∫_∂Ω du/dn for u = x^2 + y^2 on
    the unit square equals ∫ Δu dx = 4."""
    mesh = unit_square_mesh(5, 5)
    V = FunctionSpace.create(mesh, 2)
    space = MixedSpace([("u", V)])
    z = V.interpolate(lambda x: x[0] ** 2 + x[1] ** 2)
    ff = FacetForm(space, mesh.exterior_facets,
                   lambda x, u, gu, c, gc, n, k: {}, 6, device=CPU)
    dn = ff.make_functional(
        lambda x, u, gu, c, gc, n, k: torch.dot(gu["u"], n))
    assert np.isclose(float(dn(z)), 4.0, atol=1e-10)


# ------------------------------------------- against the JAX package


MESHES = {"half_disk": ("create_half_disk", {"res": 0.06}),
          "half_sphere": ("create_half_sphere", {"res": 0.2})}


def _meshes(name):
    fn, kw = MESHES[name]
    return getattr(parametric, fn)(**kw), getattr(ref_parametric, fn)(**kw)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("degree", [1, 2])
def test_trace_space_bit_identical(name, degree):
    tm, rtm = _meshes(name)
    np.testing.assert_array_equal(tm.mesh.points, rtm.mesh.points)
    tr = TraceSpace(FunctionSpace.create(tm.mesh, degree),
                    tm.facets("contact"))
    rtr = RefTraceSpace(RefFunctionSpace.create(rtm.mesh, degree),
                        rtm.facets("contact"))
    for attr in ("dofmap", "sub_to_parent", "dof_points"):
        a, b = getattr(tr, attr), getattr(rtr, attr)
        assert a.dtype == b.dtype, attr
        np.testing.assert_array_equal(a, b, err_msg=attr)
    assert tr.num_dofs == rtr.num_dofs > 0
    fn = lambda x: np.sin(x[0]) + x[1] ** 2
    np.testing.assert_array_equal(tr.interpolate(fn), rtr.interpolate(fn))


def _contact_forms(name, jacobian):
    """The Signorini facet form of both packages (u: vector P1, psi: the
    contact trace; residual with a psi_k coefficient, the normal and
    grad(u)), and a shared random state and coefficient."""
    tm, rtm = _meshes(name)
    gdim = tm.mesh.gdim
    out = []
    for pkg, t, FS, MS, TS, FF, xp in (
            ("torch", tm, FunctionSpace, MixedSpace, TraceSpace, FacetForm,
             torch),
            ("jax", rtm, RefFunctionSpace, RefMixedSpace, RefTraceSpace,
             RefFacetForm, jnp)):
        Vu = FS.create(t.mesh, 1, value_size=gdim)
        tr = TS(FS.create(t.mesh, 1), t.facets("contact"))
        space = MS([("u", Vu), ("psi", tr)])
        ng = xp.asarray(np.eye(gdim)[-1] * -1.0)
        dot = torch.dot if xp is torch else jnp.dot
        cap = ((lambda v: torch.clamp(v, max=45.0)) if xp is torch
               else (lambda v: jnp.minimum(v, 45.0)))

        def res(x, u, gu, c, gc, n, k, xp=xp, ng=ng, dot=dot, cap=cap):
            un = dot(u["u"], ng)
            return {"u": -(u["psi"] - c["psi_k"]) * ng
                    + 0.3 * dot(gu["u"][:, 0], n) * n,
                    "psi": -(un + xp.exp(cap(u["psi"]))
                             - x[gdim - 1] + 0.02) * k["alpha"]}

        def jac(x, u, gu, c, gc, n, k, res=res):
            o = res(x, u, gu, c, gc, n, k)
            o["psi"] = o["psi"] - 1e-8 * u["psi"]
            return o

        kw = {"jacobian_fn": jac if jacobian else None}
        if pkg == "torch":
            kw["device"] = CPU
        out.append((FF(space, t.facets("contact"), res, 4, **kw), space))
    (ff, space), (rff, rspace) = out
    rng = np.random.default_rng(0)
    x = rng.standard_normal(space.num_dofs) * 0.1
    psi_k = rng.standard_normal((len(ff.facets), ff.nq)) * 0.1
    return ff, rff, x, psi_k


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("what", ["residual", "element_matrices",
                                  "element_matrices_jacobian_fn",
                                  "functional"])
def test_facet_form_matches_reference(name, what):
    ff, rff, x, psi_k = _contact_forms(name, what.endswith("jacobian_fn"))
    np.testing.assert_array_equal(ff.local_indices, rff.local_indices)
    consts = {"alpha": 1.7}
    if what == "residual":
        a = ff.residual(x, {"psi_k": psi_k}, consts).numpy()
        b = np.asarray(rff.residual(jnp.asarray(x), {"psi_k": psi_k},
                                    consts))
    elif what.startswith("element_matrices"):
        a = ff.element_matrices(x, {"psi_k": psi_k}, consts).numpy()
        b = np.asarray(rff.element_matrices(jnp.asarray(x),
                                            {"psi_k": psi_k}, consts))
        if what.endswith("jacobian_fn"):
            # the eps-mass term is in the element matrices
            plain, _, _, _ = _contact_forms(name, False)
            d = a - plain.element_matrices(x, {"psi_k": psi_k},
                                           consts).numpy()
            assert 0 < np.abs(d).max() < 1e-7
    else:
        pen = lambda xp, mx: (lambda x_, u, gu, c, gc, n, k: mx(
            u["u"][-1] + x_[-1] - 0.02 + c["psi_k"], 0.0) ** 2)
        a = np.asarray(float(ff.make_functional(
            pen(torch, lambda v, z: torch.clamp(v, min=z)))(
            x, {"psi_k": psi_k})))
        b = np.asarray(float(rff.make_functional(
            pen(jnp, jnp.maximum))(jnp.asarray(x), {"psi_k": psi_k})))
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-300)
