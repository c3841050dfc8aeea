"""The port's QVI baselines (models/thermoforming_compare.py: Moreau-
Yosida, fixed point, semismooth) against the reference's, on the CPU, at
the reference test's M = 20: outer iterations, linear solves and
convergence identical, u and T within 1e-8 relative; and the reference
test's comparisons on the port's runs (the baselines agree, LVPP needs
the fewest linear solves)."""

import numpy as np
import pytest
import torch

import proximalgalerkin_tpu.models.thermoforming_compare as ref_mod

import proximalgalerkin_torch.models.thermoforming_compare as mod
from proximalgalerkin_torch.models.thermoforming import solve_thermoforming

M = 20
BASELINES = {"fixed_point_solve": {},
             "moreau_yosida_solve": {"max_outer": 15},
             "semismooth_active_set_solve": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    return {name: (getattr(mod, name)(M=M, verbose=False, device="cpu",
                                      **kw),
                   getattr(ref_mod, name)(M=M, verbose=False, **kw))
            for name, kw in BASELINES.items()}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_matches_reference(runs, name):
    res, ref = runs[name]
    assert res.converged == ref.converged
    assert res.outer_iterations == ref.outer_iterations
    assert res.linear_solves == ref.linear_solves
    assert _rel(res.u, ref.u) <= 1e-8 and _rel(res.T, ref.T) <= 1e-8


def test_baselines_agree_and_lvpp_fewest_solves(runs):
    """tests/test_thermoforming_compare.py:25-37 on the port's runs."""
    fp = runs["fixed_point_solve"][0]
    my = runs["moreau_yosida_solve"][0]
    ss = runs["semismooth_active_set_solve"][0]
    assert fp.converged
    assert np.abs(my.u - fp.u).max() < 0.05
    assert np.abs(ss.u - fp.u).max() < 0.05
    lv = solve_thermoforming(M=M, verbose=False, termination_tol=1e-7,
                             device="cpu")
    assert lv.total_newton < fp.linear_solves
    assert lv.total_newton < my.linear_solves
