"""The port's elements/ (quadrature, orthonormal bases, Lagrange
elements) against the reference package's, on the CPU: the parametrised
cases of tests/test_elements.py run through the port, and every table
they read (quadrature points and weights, modal and Lagrange values and
gradients, element nodes, facet dofs) is bit-identical to the
reference's at the same inputs."""

from math import factorial, prod

import numpy as np
import pytest

from proximalgalerkin_tpu import elements as ref

from proximalgalerkin_torch.elements import (cell_quadrature,
                                             lagrange_element, num_modes,
                                             reference_cell,
                                             tabulate_orthonormal)

CELLS_2D = ["triangle", "quadrilateral"]
ALL_CELLS = ["interval", "triangle", "quadrilateral", "tetrahedron",
             "hexahedron"]


def _identical(a, b):
    """Tables of both packages: the same shapes and the same bits."""
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.tobytes() == y.tobytes()


def _exact_monomial(cell, exps):
    """Exact integral of prod x_i^e_i over the reference cell."""
    if cell in ("interval", "quadrilateral", "hexahedron"):
        return prod(1.0 / (e + 1) for e in exps)
    if cell == "triangle":
        a, b = int(exps[0]), int(exps[1])
        return factorial(a) * factorial(b) / factorial(a + b + 2)
    a, b, c = map(int, exps)
    return factorial(a) * factorial(b) * factorial(c) / factorial(
        a + b + c + 3)


@pytest.mark.parametrize("cell", ALL_CELLS)
@pytest.mark.parametrize("degree", [1, 2, 3, 5, 8, 13, 20])
def test_quadrature_exactness(cell, degree):
    """The rule of the requested degree is the reference's, bit for bit,
    and integrates monomials of that degree exactly."""
    cref = reference_cell(cell)
    pts, w = cell_quadrature(cell, degree)
    _identical((pts, w), ref.cell_quadrature(cell, degree))
    _identical((cref.vertices, cref.volume),
               (ref.reference_cell(cell).vertices,
                ref.reference_cell(cell).volume))
    assert np.isclose(w.sum(), cref.volume)
    rng = np.random.default_rng(0)
    d = cref.dim
    for _ in range(5):
        exps = rng.multinomial(degree, np.ones(d) / d)
        if not cref.is_simplex:
            exps = np.minimum(exps, degree)
        vals = np.prod(pts ** exps[None, :], axis=1)
        quad = float(w @ vals)
        exact = _exact_monomial(cell, exps)
        assert np.isclose(quad, exact, rtol=1e-12, atol=1e-14), (exps, quad,
                                                                 exact)


@pytest.mark.parametrize("cell", ALL_CELLS)
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_orthonormal_basis(cell, degree):
    """The modal basis equals the reference's bit for bit; its mass
    matrix under quadrature is the identity, and its gradients match
    finite differences."""
    pts, w = cell_quadrature(cell, 2 * degree + 2)
    vals, grads = tabulate_orthonormal(cell, degree, pts)
    _identical((vals, grads), ref.tabulate_orthonormal(cell, degree, pts))
    assert num_modes(cell, degree) == ref.num_modes(cell, degree)
    M = np.einsum("mq,nq,q->mn", vals, vals, w)
    assert np.allclose(M, np.eye(len(vals)), atol=1e-10), M
    cref = reference_cell(cell)
    bary = cref.vertices.mean(axis=0)
    probe = 0.5 * (pts[: min(6, len(pts))] + bary)
    _, g = tabulate_orthonormal(cell, degree, probe)
    h = 1e-6
    for d in range(cref.dim):
        pp, pm = probe.copy(), probe.copy()
        pp[:, d] += h
        pm[:, d] -= h
        vp, _ = tabulate_orthonormal(cell, degree, pp)
        vm, _ = tabulate_orthonormal(cell, degree, pm)
        assert np.allclose(g[:, :, d], (vp - vm) / (2 * h), atol=1e-5)


@pytest.mark.parametrize("cell", ALL_CELLS)
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_lagrange_delta_and_unity(cell, degree):
    """The Lagrange element's nodes and tables equal the reference's bit
    for bit; it is nodal (the delta property), a partition of unity, and
    its gradients sum to zero."""
    el, rel = lagrange_element(cell, degree), ref.lagrange_element(cell,
                                                                   degree)
    assert el.ndof == num_modes(cell, degree) == rel.ndof
    _identical(el.points, rel.points)
    vals, grads = el.tabulate(el.points)
    _identical((vals, grads), rel.tabulate(el.points))
    assert np.allclose(vals, np.eye(el.ndof), atol=1e-9)
    rng = np.random.default_rng(1)
    cref = reference_cell(cell)
    pts = rng.dirichlet(np.ones(cref.num_vertices), size=20) @ cref.vertices
    v, g = el.tabulate(pts)
    _identical((v, g), rel.tabulate(pts))
    assert np.allclose(v.sum(axis=1), 1.0, atol=1e-10)
    assert np.allclose(g.sum(axis=1), 0.0, atol=1e-9)


@pytest.mark.parametrize("cell", CELLS_2D)
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_lagrange_reproduces_polynomials(cell, degree):
    """Interpolating a polynomial of the element's degree is exact, with
    the reference's tables."""
    el = lagrange_element(cell, degree)
    rng = np.random.default_rng(2)
    cref = reference_cell(cell)
    pts = rng.dirichlet(np.ones(cref.num_vertices), size=30) @ cref.vertices

    def f(x):
        return (1.0 + x[:, 0] + x[:, 1]) ** degree

    coeffs = f(el.points)
    v, g = el.tabulate(pts)
    _identical((v, g), ref.lagrange_element(cell, degree).tabulate(pts))
    assert np.allclose(v @ coeffs, f(pts), atol=1e-9)
    gx = degree * (1.0 + pts[:, 0] + pts[:, 1]) ** (degree - 1)
    assert np.allclose(g[:, :, 0] @ coeffs, gx, atol=1e-8)
    assert np.allclose(g[:, :, 1] @ coeffs, gx, atol=1e-8)


def test_dg0():
    el = lagrange_element("triangle", 0)
    assert el.ndof == 1
    assert el.discontinuous == ref.lagrange_element("triangle", 0) \
        .discontinuous is True
    v, g = el.tabulate(np.array([[0.3, 0.3]]))
    _identical((v, g), ref.lagrange_element("triangle", 0).tabulate(
        np.array([[0.3, 0.3]])))
    assert np.allclose(v, 1.0)
    assert np.allclose(g, 0.0)


@pytest.mark.parametrize("degree", [8, 12, 14])
def test_high_degree_interval_gll(degree):
    """GLL-node 1D elements (the Monge–Ampère p-sweep to 14): the
    reference's nodes and tables, nodal to 1e-8."""
    el = lagrange_element("interval", degree, variant="gll")
    rel = ref.lagrange_element("interval", degree, variant="gll")
    _identical(el.points, rel.points)
    vals, g = el.tabulate(el.points)
    _identical((vals, g), rel.tabulate(el.points))
    assert np.allclose(vals, np.eye(el.ndof), atol=1e-8)


def test_facet_dofs_triangle_p2():
    el = lagrange_element("triangle", 2)
    rel = ref.lagrange_element("triangle", 2)
    # facet 2 is edge (0,1): vertex dofs 0,1 and its edge-interior dof
    fd = el.facet_dofs(2)
    assert 0 in fd and 1 in fd and len(fd) == 3
    for f in range(3):
        assert list(el.facet_dofs(f)) == list(rel.facet_dofs(f))
