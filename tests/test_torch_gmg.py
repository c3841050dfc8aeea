"""The port's structured-grid multigrid (la/gmg.py) against the
reference's, on the CPU: the cases of tests/test_gmg.py on the port (the
stencil against the P1 operator of the port's P1ObstacleSolver, the
V-cycle as a textbook preconditioner on Poisson, the transfer operators'
shapes and partition of unity), each gmg function against the JAX one on
the same numpy inputs within 1e-12 in f64, and lattice_map equal to the
reference's, refusals included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.la import gmg as ref_gmg

from proximalgalerkin_torch.la import gmg
from proximalgalerkin_torch.mesh import rectangle_mesh, unit_square_mesh
from proximalgalerkin_torch.models.obstacle_p1 import P1ObstacleSolver
from proximalgalerkin_torch.spaces import FunctionSpace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcg(S, b, Minv, tol=1e-10, maxiter=2000):
    x = torch.zeros_like(b)
    r = b
    z = Minv(r)
    p = z
    rz = torch.sum(r * z)
    b2 = float(torch.sum(b * b))
    its = 0
    for i in range(maxiter):
        Ap = S(p)
        a = rz / torch.sum(p * Ap)
        x = x + a * p
        r = r - a * Ap
        its = i + 1
        if float(torch.sum(r * r)) <= tol * tol * b2:
            break
        z = Minv(r)
        rz2 = torch.sum(r * z)
        p = z + (rz2 / rz) * p
        rz = rz2
    return x, its


def test_stencil_matches_dia_operator():
    """stencil_apply == free*(alpha*A + m2d) + (1-free) with A the
    DIA-assembled P1 stiffness of the port's P1ObstacleSolver
    (rectangle_mesh numbering is lexicographic)."""
    n = 32
    mesh = rectangle_mesh(n, n, p0=(-1, -1), p1=(1, 1))
    s = P1ObstacleSolver(mesh, device="cpu")
    m = n + 1
    rng = np.random.default_rng(0)
    free = s.interior > 0
    m2d = torch.as_tensor(np.where(free.numpy(), rng.uniform(0.1, 3.0, s.N),
                                   0.0))
    alpha = torch.tensor(7.5, dtype=torch.float64)
    v = torch.as_tensor(rng.normal(size=s.N))
    vf = torch.where(free, v, 0.0)
    want = torch.where(free, alpha * s.dia.spmv(vf) + m2d * v, v)
    got = gmg.stencil_apply(v.reshape(m, m), alpha, m2d.reshape(m, m),
                            free.reshape(m, m))
    assert float(torch.abs(got.reshape(-1) - want).max()) < 1e-11


def test_vcycle_textbook_on_poisson():
    """MG-PCG on the interior Laplacian: <= 15 iterations where
    Jacobi-CG needs hundreds, the same solution."""
    m = 65
    free_np = np.zeros((m, m), bool)
    free_np[1:-1, 1:-1] = True
    free = torch.as_tensor(free_np)
    h2 = (2.0 / (m - 1)) ** 2
    m2d = torch.where(free, h2, 0.0).to(torch.float64)
    al = torch.tensor(1.0, dtype=torch.float64)
    rng = np.random.default_rng(1)
    b = torch.as_tensor(np.where(free_np, rng.normal(size=(m, m)), 0.0))

    def S(v):
        return gmg.stencil_apply(v, al, m2d, free)

    levels = gmg.mg_levels_for(m)
    assert levels >= 2
    hier = gmg.build_hierarchy(m2d, free, levels)
    diag = torch.where(free, 4.0 * al + m2d, 1.0)
    x_j, it_j = _pcg(S, b, lambda r: r / diag)
    x_m, it_m = _pcg(S, b, lambda r: gmg.v_cycle(r, hier, al))
    assert it_m <= 15, it_m
    assert it_j >= 5 * it_m, (it_j, it_m)
    assert float(torch.abs(x_j - x_m).max()) < 1e-7


def test_restrict_prolong_shapes_and_partition():
    """Transfer operators: shapes halve/double; full weighting preserves
    constants in the interior; prolongation of a constant is constant."""
    m = 17
    rc = gmg.restrict(torch.ones((m, m), dtype=torch.float64))
    assert rc.shape == (9, 9)
    assert float(torch.abs(rc[1:-1, 1:-1] - 1.0).max()) < 1e-14
    f = gmg.prolong(torch.ones((9, 9), dtype=torch.float64), (m, m))
    assert f.shape == (m, m)
    assert float(torch.abs(f - 1.0).max()) < 1e-14


def _grids(m, seed):
    """A lattice state: free interior with a few fixed points, a
    variable alpha, m2d and a right-hand side, as numpy arrays."""
    rng = np.random.default_rng(seed)
    free = np.zeros((m, m), bool)
    free[1:-1, 1:-1] = True
    free[rng.integers(1, m - 1, 6), rng.integers(1, m - 1, 6)] = False
    alpha = rng.uniform(0.5, 2.0, (m, m))
    m2d = np.where(free, rng.uniform(0.0, 0.1, (m, m)), 0.0)
    r = np.where(free, rng.normal(size=(m, m)), 0.0)
    return free, alpha, m2d, r


def _close(got, want, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("fn", ["stencil_apply", "restrict", "prolong",
                                "hierarchy", "v_cycle", "hierarchy_var",
                                "v_cycle_var"])
def test_matches_reference(fn):
    m = 33
    free, alpha, m2d, r = _grids(m, 3)
    t = torch.as_tensor
    j = jnp.asarray
    if fn == "stencil_apply":
        _close(gmg.stencil_apply(t(r), t(alpha), t(m2d), t(free)),
               ref_gmg.stencil_apply(j(r), j(alpha), j(m2d), j(free)))
    elif fn == "restrict":
        _close(gmg.restrict(t(r)), ref_gmg.restrict(j(r)))
    elif fn == "prolong":
        c = r[::2, ::2]
        _close(gmg.prolong(t(c), (m, m)), ref_gmg.prolong(j(c), (m, m)))
    elif fn in ("hierarchy", "v_cycle"):
        levels = gmg.mg_levels_for(m, coarsest=9)
        assert levels == ref_gmg.mg_levels_for(m, coarsest=9) == 3
        h = gmg.build_hierarchy(t(m2d), t(free), levels)
        rh = ref_gmg.build_hierarchy(j(m2d), j(free), levels)
        if fn == "hierarchy":
            for (a, fa), (b, fb) in zip(h, rh):
                _close(a, b)
                np.testing.assert_array_equal(fa.numpy(), np.asarray(fb))
        else:
            al = 1.7
            _close(gmg.v_cycle(t(r), h, torch.tensor(al, dtype=torch.float64),
                               nu=3),
                   ref_gmg.v_cycle(j(r), rh, j(al), nu=3))
    else:
        levels = 3
        h = gmg.build_hierarchy_var(t(alpha), t(m2d), t(free), levels)
        rh = ref_gmg.build_hierarchy_var(j(alpha), j(m2d), j(free), levels)
        if fn == "hierarchy_var":
            for (a, b, fa), (ra, rb, rfa) in zip(h, rh):
                _close(a, ra)
                _close(b, rb)
                np.testing.assert_array_equal(fa.numpy(), np.asarray(rfa))
        else:
            _close(gmg.v_cycle_var(t(r), h), ref_gmg.v_cycle_var(j(r), rh))


def test_levels_and_lattice_map_match_reference():
    for m in (5, 9, 16, 17, 33, 65, 401, 1025):
        assert gmg.mg_levels_for(m) == ref_gmg.mg_levels_for(m)
    # P2 dofs on a uniform triangulation, Q2 dofs on a quad grid and P1
    # dofs on a uniform triangulation form complete lattices
    for mesh, deg in ((unit_square_mesh(6, 4), 2),
                      (unit_square_mesh(5, 5, cell_type="quadrilateral"), 2),
                      (unit_square_mesh(7, 3), 1)):
        pts = FunctionSpace.create(mesh, deg).dof_points
        perm, shape = gmg.lattice_map(pts)
        rperm, rshape = ref_gmg.lattice_map(pts)
        np.testing.assert_array_equal(perm, rperm)
        assert shape == rshape
        grid = pts[perm].reshape(*shape, 2)
        assert (np.diff(grid[..., 0], axis=1) > 0).all()
        assert (np.diff(grid[..., 1], axis=0) > 0).all()
    # refusals: an incomplete lattice, points off the lattice, 3D points
    pts = FunctionSpace.create(unit_square_mesh(4, 4), 2).dof_points
    for bad in (pts[1:], pts + np.where(np.arange(len(pts)) == 3, 1e-3,
                                        0.0)[:, None],
                np.zeros((4, 3))):
        with pytest.raises(ValueError, match="lattice_map"):
            gmg.lattice_map(bad)
        with pytest.raises(ValueError, match="lattice_map"):
            ref_gmg.lattice_map(bad)
