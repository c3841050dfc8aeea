"""The port's distributed fracture continuation (models/fracture.py with
n_devices, on parallel/dofpart.py) against the reference package's, on
the CPU with 8 subdomains: tests/test_fracture.py:49-70's first load step
(T = 0.1) with its distributed options (MINRES on the matrix-free
action) on the res 0.4 crack mesh, with per-step counts identical to the
reference's 8-device run and c, u within 1e-10, and that run's checkpoint
resumed by the port's distributed continuation."""

import numpy as np
import pytest
import torch

import proximalgalerkin_tpu.models.fracture as ref_mod

import proximalgalerkin_torch.models.fracture as mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The distributed continuation with tests/test_fracture.py:49-70's
# options (MINRES on the matrix-free action) and its first load, T = 0.1
# (linspace(0, 0.1, 2)[1:]): the boundary values move off zero, and the
# damage field evolves from psi = 0 over a dozen LVPP steps. At the
# reference test's res 0.25 the port's eager jvp MINRES takes about 200 s
# on the CPU for the first load step and 525 s for all four (PERF.md §7);
# the card runs the res 0.1 record's first load step against the JAX
# package's counts (chip_smoke.py phase 14) and tests/test_torch_gpu.py
# holds the card to the CPU.
DIST_OPTS = {"snes_linesearch_type": "l2", "snes_atol": 1e-6,
             "snes_rtol": 1e-8, "snes_max_it": 30, "ksp_type": "minres",
             "pc_type": "jacobi", "mat_type": "matfree",
             "ksp_rtol": 1e-11, "ksp_max_it": 4000}
DIST_KW = dict(max_res=0.4, Tmax=0.1, num_load_steps=2, verbose=False,
               solver_options=DIST_OPTS)


@pytest.fixture(scope="module")
def distributed(tmp_path_factory):
    """The port's continuation on 8 subdomains and the reference's
    8-device run (which tests/test_fracture.py proves equal to its host
    run), checkpointing its load step."""
    ck = tmp_path_factory.mktemp("fracture_dist") / "ck.npz"
    ref = ref_mod.solve_fracture(n_devices=8, checkpoint_path=str(ck),
                                 checkpoint_every=1, **DIST_KW)
    return (mod.solve_fracture(n_devices=8, device="cpu", **DIST_KW),
            ref, ck)


def test_distributed_continuation_matches_reference(distributed):
    """Per-step Newton, LVPP and retry counts identical to the
    reference's, c and u within 1e-10, under a nonzero load."""
    res, ref, _ = distributed
    assert res.load_history == ref.load_history == [0.1]
    assert res.newton_per_step == ref.newton_per_step
    assert res.lvpp_per_step == ref.lvpp_per_step
    assert res.lvpp_per_step[0] > 5
    assert res.retries_per_step == ref.retries_per_step
    assert res.broken == ref.broken
    assert np.abs(res.c - ref.c).max() < 1e-10
    assert np.abs(res.u - ref.u).max() < 1e-10
    assert np.abs(np.subtract(res.max_damage_history,
                              ref.max_damage_history)).max() < 1e-10


def test_distributed_resumes_reference_distributed_checkpoint(distributed,
                                                              tmp_path):
    """The reference's 8-device checkpoint (global vectors) read by the
    port's distributed continuation: scattered onto its shards, it is the
    state the port's own run reached, and the histories come through."""
    res, ref, ck = distributed
    path = tmp_path / "ck.npz"
    path.write_bytes(ck.read_bytes())
    back = mod.solve_fracture(n_devices=8, device="cpu",
                              checkpoint_path=str(path), **DIST_KW)
    assert back.newton_per_step == ref.newton_per_step
    assert back.lvpp_per_step == ref.lvpp_per_step
    assert back.load_history == ref.load_history
    assert np.abs(back.c - res.c).max() < 1e-10
    assert np.abs(back.u - res.u).max() < 1e-10
