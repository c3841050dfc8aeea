"""The element-by-element product (ops/ebe.py) and the distributed
Newton's Jacobian action built on it (parallel/dofpart.py, the Schwarz
paths asm_btlu and asm_lu), on the CPU: the plain version against a
dense assembled product, the wrapper's refusals, and the element-matrix
action against the jvp action it replaces, on the benchmark's
distributed cell at 16^2 with 8 subdomains and on the Signorini
composite (a facet leg) of test_torch_dofpart.py."""

from pathlib import Path

import numpy as np
import pytest
import torch

from pgbench import harness, inputs
from proximalgalerkin_torch.core.logging import counter
from proximalgalerkin_torch.ops.ebe import (MAX_L, ebe_apply,
                                            ebe_apply_reference)
from proximalgalerkin_torch.parallel.dofpart import DistributedProblem

ROOT = Path(__file__).resolve().parents[1]
f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, ref) -> float:
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _random_ebe(ne: int, L: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((ne, L, L)))
    # few slots per element: indices repeat within and across elements
    gidx = torch.as_tensor(rng.integers(0, n - 3, (ne, L)), dtype=torch.int32)
    x = torch.as_tensor(rng.standard_normal(n))
    return A, gidx, x


@pytest.mark.parametrize("L", [3, 6, 9])
def test_reference_is_the_dense_assembled_product(L):
    """y = (sum_c P_c^T A_c P_c) x, assembled densely in numpy, with
    indices repeated inside elements and across them and out_size past
    the last index."""
    n, ne = 25, 40
    A, gidx, x = _random_ebe(ne, L, n, seed=L)
    M = np.zeros((n + 4, n))
    g = gidx.numpy().astype(np.int64)
    for c in range(ne):
        np.add.at(M, (g[c][:, None], g[c][None, :]), A[c].numpy())
    y = ebe_apply_reference(A, gidx, x, n + 4)
    assert y.shape == (n + 4,) and y.dtype == f64
    assert _rel(y, M @ x.numpy()) <= 1e-13
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(ebe_apply(A, gidx, x, n + 4), y)


def test_ebe_apply_rejects_bad_inputs():
    A, gidx, x = _random_ebe(10, 6, 30, seed=0)
    bad = [
        ((A.float(), gidx, x, 30), TypeError),
        ((A, gidx, x.float(), 30), TypeError),
        ((A, gidx.long(), x, 30), TypeError),
        ((A[:, :, :5], gidx, x, 30), ValueError),
        ((A, gidx[:, :5], x, 30), ValueError),
        ((torch.zeros(10, MAX_L + 1, MAX_L + 1, dtype=f64),
          torch.zeros(10, MAX_L + 1, dtype=torch.int32), x, 30), ValueError),
        ((A.transpose(1, 2), gidx, x, 30), ValueError),
        ((A, gidx, x[::2], 30), ValueError),
        ((A, gidx, x[:, None], 30), ValueError),
        ((A, gidx, x, 0), ValueError),
        ((A, gidx, x, 2**31), ValueError),
        ((A.to("meta"), gidx, x, 30), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            ebe_apply(*args)


# ----------------------------------------- the distributed Schwarz action

@pytest.fixture(scope="module")
def cell16():
    """The benchmark's distributed cell at 16^2 (8 subdomains) and a
    random linearization point with its coefficients."""
    cell = harness.load_cell(ROOT, "obstacle_dist_224.asm_btlu")
    cell.config["n"] = 16
    inp = inputs.make(cell.config, cell.workload["params"], 2**31 + 17)
    state = cell.driver().setup(cell.config, cell.workload, inp,
                                torch.device("cpu"))
    dp = state.dp
    N = state.prob.space.num_dofs
    rng = np.random.default_rng(5)
    x = dp.scatter(0.5 * rng.standard_normal(N))
    xk = dp.scatter(0.5 * rng.standard_normal(N))
    coeffs = dict(state.solver.problem.coeffs,
                  psi_k=dp.field_to_coeff(xk, "psi"),
                  u_k=dp.field_to_coeff(xk, "u"))
    consts = {"alpha": torch.tensor(3.0, dtype=f64)}
    vs = [dp.scatter(rng.standard_normal(N)) for _ in range(3)]
    return dp, x, dp._prep_coeffs(coeffs), consts, vs


@pytest.mark.parametrize("pc", ["asm_btlu", "asm_lu"])
def test_schwarz_action_is_the_jvp_action(cell16, pc):
    """The Newton step's action on the Schwarz paths (from the factor's
    cell element matrices) equals the jvp action within 1e-13 relative,
    Dirichlet rows included (there both return v), and counts one
    `dist.ebe_actions` a call."""
    dp, x, cv, consts, vs = cell16
    bcm = dp.bc_mask
    Av, Minv = dp._schwarz_operators(x, cv, {}, consts, bcm, pc, "f64")
    jvp = dp._jac_action(x, cv, {}, consts, bcm)
    before = counter("dist.ebe_actions")
    for v in vs:
        y, ref = Av(v), jvp(v)
        assert _rel(y, ref) <= 1e-13
        assert torch.equal(y[bcm], v[bcm])
    assert counter("dist.ebe_actions") - before == len(vs)
    assert torch.isfinite(Minv(vs[0])).all()


def test_signorini_element_matrix_action_is_the_jvp_action():
    """The Signorini composite (volume elasticity + a contact facet leg on
    a trace space): the action from its cell and facet element matrices
    equals its jacobian_action within 1e-13 relative; without the facet
    leg's matrices it would not."""
    from test_torch_dofpart import _signorini_pair
    (p, space, ff), _ = _signorini_pair()
    dp = DistributedProblem(p, n_devices=8)
    assert len(dp.facet_forms) == 1
    rng = np.random.default_rng(0)
    N = space.num_dofs
    xs = dp.scatter(rng.standard_normal(N) * 0.01)
    nfac, nq = ff.facet_data["wdet"].shape
    fc = {"psi_k": dp.scatter_facetq(rng.standard_normal((nfac, nq)) * 0.01)}
    consts = dict(dp.consts)
    cv, fcv = dp._prep_coeffs(None), dp._flat_facet(fc)
    Ae = dp._cell_matrices(xs, cv, consts)
    Av = dp._ebe_action(xs, Ae, fcv, consts, dp.bc_mask)
    bcm, n = dp.bc_mask, dp.nloc * dp.ext_total

    def cells_only(v):
        w = dp._forward_ext(torch.where(bcm, 0.0, v)).reshape(-1)
        t = ebe_apply(Ae, dp._ebe_index()[0], w, n)
        return torch.where(bcm, v, dp._reverse_fold(
            t.reshape(dp.nloc, dp.ext_total)))

    for _ in range(2):
        v = dp.scatter(rng.standard_normal(N))
        ref = dp.jacobian_action(xs, v, facet_coeffs=fc)
        assert _rel(Av(v), ref) <= 1e-13
        assert _rel(cells_only(v), ref) > 1e-6
