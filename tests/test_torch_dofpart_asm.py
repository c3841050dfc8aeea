"""The restricted additive Schwarz options of the port's distributed
Newton (parallel/dofpart.py: asm_lu, a dense subdomain LU, and asm_btlu,
a block-tridiagonal subdomain factor, both under right-preconditioned
GMRES(120)) against the reference package, on the CPU with 8
subdomains: the two Schwarz cases of tests/test_dofpart.py's line-search
and Schur variants, and the asm_btlu-against-Jacobi strength case. The
helpers are test_torch_dofpart_lvpp.py's."""

import numpy as np
import pytest
import torch

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
# distributed problem on 8 virtual CPU devices, the port's options),
# except the budget-capped Schwarz run's 8th LVPP step: there the capped
# classical-Gram-Schmidt GMRES leaves |F| / |F0| at 7.8e-7 after two
# Newton steps in the port and just above the 1e-6 rtol in the reference,
# which takes a third (ROADMAP C). Both stop at step 9 on a NaN residual.
REFERENCE_STEPS = {"exact": [5, 3, 3, 3, 3, 3, 3, 1, 3],
                   "strong": [5, 3, 3, 3, 3, 3, 3, 2],
                   "weak": [5, 3, 3, 3, 3, 3, 3, 1, 3]}


@pytest.mark.parametrize("tag", ["preonly/asm_lu", "preonly/asm_btlu"])
def test_distributed_linesearch_and_schur_variants(variants, tag):
    check_variant(variants, tag)


def test_asm_btlu_pc_strength_vs_jacobi():
    """The strong PC must help, not just converge: at deep-alpha
    conditioning (9 LVPP steps, alpha to ~1e5) with a per-direction
    Krylov budget of 150, RAS-btlu GMRES still lands within 1e-4 of the
    exact-direction solution while Jacobi-MINRES under the same budget is
    over 100x further off. Each run's Newton counts are held to
    REFERENCE_STEPS."""
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
    # the reference's runs, counted on its 8 virtual devices
    assert steps == REFERENCE_STEPS
    err_strong = np.max(np.abs(u["strong"] - u["exact"]))
    err_weak = np.max(np.abs(u["weak"] - u["exact"]))
    assert err_strong < 1e-4, err_strong
    assert err_weak > 100 * max(err_strong, 1e-12), (err_weak, err_strong)
