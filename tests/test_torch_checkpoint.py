"""Checkpoint and resume of the port's multiphase model against the
reference package's, on the CPU: the multiphase resume of
tests/test_checkpoint.py (N = M = 8, tau0 1e-4, T 5e-4, a snapshot every
2 time steps, resumed at step 4) in the port, with the reference's Newton
counts and u within 1e-10; and across packages: the file layout of
utils/checkpoint.LVPPCheckpoint is the reference's, a snapshot written by
either package loads in the other's LVPPCheckpoint, and each package
resumes from the other's snapshot to the same counts and u."""

import json
import shutil

import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.models.multiphase import \
    solve_multiphase as ref_solve_multiphase
from proximalgalerkin_tpu.utils.checkpoint import \
    LVPPCheckpoint as RefCheckpoint

from proximalgalerkin_torch.models.multiphase import solve_multiphase
from proximalgalerkin_torch.utils.checkpoint import LVPPCheckpoint

KW = dict(N=8, M=8, tau0=1e-4, T=5e-4, max_iterations=8, verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(**kw):
    return solve_multiphase(device="cpu", **KW, **kw)


def _ref(**kw):
    return ref_solve_multiphase(**KW, **kw)


def _same_run(a, b, atol=1e-10):
    assert np.array_equal(a.newton_iterations, b.newton_iterations)
    assert np.array_equal(a.lvpp_iterations, b.lvpp_iterations)
    assert np.max(np.abs(np.asarray(a.u) - np.asarray(b.u))) < atol


def test_multiphase_checkpoint_resume(tmp_path):
    # the uninterrupted runs, each writing snapshots at steps 2 and 4
    ck_p, ck_r = tmp_path / "port.npz", tmp_path / "ref.npz"
    m0 = _port(checkpoint_path=str(ck_p), checkpoint_every=2)
    r0 = _ref(checkpoint_path=str(ck_r), checkpoint_every=2)
    _same_run(m0, r0)

    # one layout: the same arrays and metadata keys, each file read by
    # both packages' loaders alike
    files = {ck_p: np.load(ck_p), ck_r: np.load(ck_r)}
    assert {tuple(sorted(f.files)) for f in files.values()} == {
        ("meta", "x", "x_k")}
    assert len({tuple(sorted(json.loads(str(f["meta"]))))
                for f in files.values()}) == 1
    for path in files:
        mine, theirs = LVPPCheckpoint.load(path), RefCheckpoint.load(path)
        assert mine.step == theirs.step == 4  # the last before step 5
        assert mine.newton_steps == theirs.newton_steps == \
            [int(v) for v in r0.newton_iterations[:4]]
        assert np.array_equal(mine.x_k, theirs.x_k)
        assert np.array_equal(mine.x, theirs.x)
    # the states at step 4 (the latent fields reach about 17 in size)
    xp, xr = LVPPCheckpoint.load(ck_p).x_k, LVPPCheckpoint.load(ck_r).x_k
    assert np.max(np.abs(xp - xr)) < 1e-9 * np.max(np.abs(xr))

    # resume at step 4: the port from its own snapshot and from the
    # reference's, the reference from the port's
    def resumed(solve, src, name):
        dst = tmp_path / name
        shutil.copy(src, dst)
        return solve(checkpoint_path=str(dst))

    _same_run(resumed(_port, ck_p, "p_from_p.npz"), m0)
    _same_run(resumed(_port, ck_r, "p_from_r.npz"), r0)
    _same_run(resumed(_ref, ck_p, "r_from_p.npz"), r0)
