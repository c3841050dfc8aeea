"""The port's la/ordering.py (nested-dissection order, block
permutations, field rotation) and its lagged nested-dissection LU Newton
against the reference package's, on the CPU: the cases of
tests/test_ordering.py run through the port, the orders and rotations
equal to the reference's, and the multiphase lagged-ND run of that test
with the reference's counts."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from proximalgalerkin_tpu.la import ordering as ref
from proximalgalerkin_tpu.models.multiphase import \
    solve_multiphase as ref_solve_multiphase

from proximalgalerkin_torch.la.direct import LUFactorization
from proximalgalerkin_torch.la.ordering import (best_field_rotation,
                                                block_permutations,
                                                coordinate_nd_order)
from proximalgalerkin_torch.models.multiphase import solve_multiphase


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid_graph(n):
    idx = np.arange(n * n).reshape(n, n)
    rows, cols = [], []
    for di, dj in ((0, 1), (1, 0)):
        a = idx[: n - di, : n - dj].ravel()
        b = idx[di:, dj:].ravel()
        rows += [a, b]
        cols += [b, a]
    r = np.concatenate(rows + [np.arange(n * n)])
    c = np.concatenate(cols + [np.arange(n * n)])
    A = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n * n, n * n))
    return A.tocsr()


def _grid_points(n):
    return np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                    -1).reshape(-1, 2).astype(float)


@pytest.mark.parametrize("n, leaf", [(13, 8), (20, 4)])
def test_nd_order_is_permutation(n, leaf):
    """The ND order is a permutation and equals the reference's."""
    G, pts = _grid_graph(n), _grid_points(n)
    order = coordinate_nd_order(G, pts, leaf=leaf)
    assert np.array_equal(np.sort(order), np.arange(n * n))
    assert np.array_equal(order, ref.coordinate_nd_order(G, pts, leaf=leaf))


def test_nd_reduces_fill_vs_natural():
    n = 48
    G = _grid_graph(n)
    A = (sp.diags(np.full(n * n, 5.0)) - G).tocsr()
    pts = _grid_points(n)
    order = coordinate_nd_order(G, pts, leaf=8)
    dof_nodes = np.arange(n * n)
    pr, pc = block_permutations(dof_nodes, order)
    rpr, rpc = ref.block_permutations(dof_nodes, order)
    assert np.array_equal(pr, rpr) and np.array_equal(pc, rpc)
    lu_nat = spla.splu(A.tocsc(), permc_spec="NATURAL")
    lu_col = spla.splu(A.tocsc(), permc_spec="COLAMD")
    lu_nd = spla.splu(A[pr][:, pc].tocsc(), permc_spec="NATURAL")
    fill = lu_nd.L.nnz + lu_nd.U.nnz
    assert fill < 0.5 * (lu_nat.L.nnz + lu_nat.U.nnz)
    assert fill < lu_col.L.nnz + lu_col.U.nnz
    b = np.random.default_rng(0).standard_normal(n * n)
    x = LUFactorization(A, perm_r=pr, perm_c=pc, pivot_thresh=0.01).solve(b)
    assert np.linalg.norm(A @ x - b) < 1e-10 * np.linalg.norm(b)


def test_field_rotation_detects_zero_diagonal_block():
    # 2-field system per node: [[M, M], [M, 0]] — field-1 diagonal block
    # is zero; the rotation must pair field-1 rows with field-0 columns.
    n_nodes = 25
    M = sp.diags(np.full(n_nodes, 2.0)) + sp.diags(
        np.full(n_nodes - 1, -0.5), 1) + sp.diags(
        np.full(n_nodes - 1, -0.5), -1)
    Z = sp.csr_matrix((n_nodes, n_nodes))
    A = sp.bmat([[M, M], [M, Z]]).tocsr()
    dof_nodes = np.concatenate([np.arange(n_nodes), np.arange(n_nodes)])
    field_of = np.concatenate([np.zeros(n_nodes, np.int64),
                               np.ones(n_nodes, np.int64)])
    rot = best_field_rotation(A, dof_nodes, field_of)
    assert rot == {0: 1, 1: 0} == ref.best_field_rotation(A, dof_nodes,
                                                          field_of)


def test_multiphase_lagged_nd_matches_plain_lu():
    """The lagged ND-LU Newton on the reference test's 10^2 multiphase,
    both of its time steps (the lagged factor carries over into the
    second), takes the reference's lagged run's counts, which the
    reference test holds equal to its plain LU run's, with u within
    1e-8. About 70 s on the CPU: the port's lagged refinement applies the
    eager jvp action about 1,100 times, 30 ms each (ROADMAP C4)."""
    kw = dict(N=10, M=10, tau0=1e-4, T=2e-4, verbose=False,
              solver_options={"pc_factor_lag": 1,
                              "pc_factor_ordering": "nd"})
    lagged = solve_multiphase(device="cpu", **kw)
    r = ref_solve_multiphase(**kw)
    assert np.array_equal(lagged.newton_iterations, r.newton_iterations)
    assert np.array_equal(lagged.lvpp_iterations, r.lvpp_iterations)
    assert np.max(np.abs(lagged.u - r.u)) < 1e-8
