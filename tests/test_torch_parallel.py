"""The port's shard axis (parallel/comm.py), halo-exchange FD solver
(parallel/halo.py) and cell sharding (parallel/sharding.py) against the
reference package, on the CPU: ShardComm's ring and psum against the
reference's ppermute pairs; fd_obstacle_solve_sharded(33) on 8 strips
against the reference's single-device solve (u within 1e-12, Newton
counts within the reference test's 2), its counts against the reference's
sharded run's (pinned), and against the port's single-device
fd_obstacle_solve; the cell-sharded residual within 1e-12 of the
unsharded one, with shard_form's refusal of an uneven split."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proximalgalerkin_torch.mesh import rectangle_mesh
from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
from proximalgalerkin_torch.models.obstacle_fd import fd_obstacle_solve
from proximalgalerkin_torch.parallel import (ShardComm, device_mesh,
                                             replicated, shard_form,
                                             shard_problem)
from proximalgalerkin_torch.parallel.halo import fd_obstacle_solve_sharded

f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ring_psum_and_axis_index(fake_world):
    """ring(x, s): shard i gets shard (i + s) mod nd, the reference's
    _ring_perm pairs; psum sums the shard axis; axis_index lists the
    shards."""
    from proximalgalerkin_tpu.parallel.dofpart import _ring_perm
    comm = ShardComm(8, "cpu")
    x = torch.arange(8 * 5, dtype=f64).reshape(8, 5)
    for s in range(-9, 10):
        y = comm.ring(x, s)
        for src, dst in _ring_perm(8, s):
            assert torch.equal(y[dst], x[src])
    assert torch.equal(comm.psum(x), x.sum(0))
    assert comm.axis_index().tolist() == list(range(8))
    assert (comm.world, comm.nloc, comm.local) == (1, 8, slice(0, 8))
    with pytest.raises(ValueError, match="evenly"):
        ShardComm(3, "cpu", group=_FakeGroup())


class _FakeGroup:
    pass


@pytest.fixture
def fake_world(monkeypatch):
    """A world of two processes for the uneven-split refusal above."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_world_size",
                        lambda g=None: 2 if isinstance(g, _FakeGroup)
                        else 1)
    monkeypatch.setattr(dist, "get_rank", lambda g=None: 0)


# The reference's fd_obstacle_solve_sharded(33) on its 8 virtual devices
# counts 10 outer / 17 Newton steps; its compile alone takes over a minute
# here, so the port is held to the reference's single-device solve under
# the reference test's own bounds, and chip_smoke.py pins the sharded
# counts (REFERENCE_COUNTS["halo_33"], from `python
# scripts/jax_reference_records.py halo_33`).
HALO_33 = {"outer": 10, "newton": 17}


def test_halo_exchange_matches_single_device():
    from proximalgalerkin_tpu.models.obstacle_fd import \
        fd_obstacle_solve as ref_fd
    counts = {}
    u, phi, outer, newton = fd_obstacle_solve_sharded(33, device="cpu",
                                                      counts=counts)
    ref = ref_fd(33)
    assert np.abs(u - np.asarray(ref.u)).max() < 1e-12
    assert abs(newton - ref.newton_its) <= 2
    np.testing.assert_array_equal(phi, np.asarray(ref.phi))
    assert {"outer": outer, "newton": newton} == HALO_33
    one = fd_obstacle_solve(33, device="cpu")
    assert np.abs(u - one.u).max() < 1e-12
    assert sum(counts["newton_per_outer"]) == newton
    assert counts["cg_its"] > 0


def test_halo_strip_counts_agree():
    """2, 3 and 8 strips (3 pads the 33 rows to 36) give one solution."""
    runs = [fd_obstacle_solve_sharded(17, device="cpu", n_devices=n)
            for n in (2, 3, 8)]
    for u, _, outer, newton in runs[1:]:
        assert (outer, newton) == runs[0][2:]
        assert np.abs(u - runs[0][0]).max() < 1e-12


def _obstacle_at_alpha1(mesh):
    prob = setup_obstacle_problem(mesh, verbose=False, device="cpu")
    p = prob.problem
    x = p.set_bc(torch.as_tensor(prob.space.zeros(), dtype=f64))
    p.update(coeffs={"psi_k": x[prob.space.slice_of("psi")],
                     "u_k": x[prob.space.slice_of("u")]},
             consts={"alpha": torch.tensor(1.0, dtype=f64)})
    return prob, p, x


def test_gspmd_sharded_residual_matches():
    """Cell-sharded assembly (8 blocks, their scatter-adds psum'd) gives
    the unsharded residual, Jacobian action and diagonal to 1e-12, and
    the reference's sharded residual."""
    from proximalgalerkin_tpu.mesh import rectangle_mesh as ref_rect
    from proximalgalerkin_tpu.models import setup_obstacle_problem as rsetup
    from proximalgalerkin_tpu.parallel import (device_mesh as rmesh,
                                               replicated as rrep,
                                               shard_problem as rshard)
    import jax

    mesh = rectangle_mesh(16, 16, p0=(-1, -1), p1=(1, 1))
    _, pa, x = _obstacle_at_alpha1(mesh)
    F_ref = pa.residual(x).numpy()
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(len(x)))
    Jv_ref = pa.jacobian_action(x)(v).numpy()
    d_ref = pa.jacobian_diagonal(x).numpy()

    prob_b, pb, _ = _obstacle_at_alpha1(mesh)
    comm = device_mesh(8, device="cpu")
    assert replicated(comm) == torch.device("cpu")
    shard_problem(pb, comm)
    assert pb.coeffs["phi"].shape[0] == mesh.num_cells
    assert prob_b.form.cell_data["wdet"].shape[0] == mesh.num_cells
    assert np.abs(pb.residual(x).numpy() - F_ref).max() < 1e-12
    assert np.abs(pb.jacobian_action(x)(v).numpy() - Jv_ref).max() < 1e-12
    assert np.abs(pb.jacobian_diagonal(x).numpy() - d_ref).max() < 1e-12

    rprob = rsetup(ref_rect(16, 16, p0=(-1, -1), p1=(1, 1)), verbose=False)
    rp = rprob.problem
    dm = rmesh(8)
    rshard(rp, dm)
    xr = jax.device_put(jnp.asarray(x.numpy()), rrep(dm))
    rp.update(coeffs={"psi_k": xr[rprob.space.slice_of("psi")],
                      "u_k": xr[rprob.space.slice_of("u")]},
              consts={"alpha": jnp.asarray(1.0)})
    assert np.abs(pb.residual(x).numpy()
                  - np.asarray(rp.residual(xr))).max() < 1e-12


def test_shard_form_refuses_uneven_split():
    mesh = rectangle_mesh(5, 3)                 # 30 cells
    prob, _, _ = _obstacle_at_alpha1(mesh)
    with pytest.raises(ValueError, match="not divisible"):
        shard_form(prob.form, device_mesh(8, device="cpu"))
    shard_form(prob.form, device_mesh(5, device="cpu"))
