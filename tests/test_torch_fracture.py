"""The port's phase-field fracture (models/fracture.py) against the
reference's, on the CPU: the crack mesh, the reference test's load
continuation (res 0.2, T up to 2.4, 9 load steps) with Newton, LVPP and
retry counts per load step and `broken` identical and u, c within 1e-8
relative; the reference test's physical checks on the port's solution;
a continuation the reference checkpoints at load step 4, resumed by the
port; the residual, element matrices and Jacobian diagonal of the form
(the energy's gradient by torch.func.grad inside the residual, the
regularized jacobian_fn) on a handful of cells; moving Dirichlet data;
and the fracture CLI, on one device and on 8 subdomains (the
distributed continuation's parity cases are in
test_torch_fracture_distributed.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import proximalgalerkin_tpu.models.fracture as ref_mod
from proximalgalerkin_tpu.mesh.unstructured import \
    create_crack_mesh as ref_crack_mesh
from proximalgalerkin_tpu.models.multiphase import \
    _circumradius as ref_circumradius

import proximalgalerkin_torch.models.fracture as mod
from proximalgalerkin_torch.mesh.unstructured import create_crack_mesh

KW = dict(max_res=0.2, Tmin=0.0, Tmax=2.4, num_load_steps=9, verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """Both packages' continuations; the reference's also checkpoints
    every 4 load steps, and its step-4 snapshot is kept aside."""
    from proximalgalerkin_tpu.utils.checkpoint import LVPPCheckpoint
    ck = tmp_path_factory.mktemp("fracture") / "ck.npz"
    ck4 = ck.with_name("ck4.npz")
    real_save = LVPPCheckpoint.save

    def save(self, path):
        if self.step == 4:
            real_save(self, ck4)
        return real_save(self, path)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LVPPCheckpoint, "save", save)
        ref = ref_mod.solve_fracture(checkpoint_path=str(ck),
                                     checkpoint_every=4, **KW)
    assert ck4.exists()
    return mod.solve_fracture(device="cpu", **KW), ref, ck4


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_crack_mesh_regions():
    tm = create_crack_mesh(0.15)
    ref = ref_crack_mesh(0.15)
    for name in ("bottom", "right", "topright", "crackright", "crackleft",
                 "topleft", "left", "hole"):
        assert len(tm.facets(name)) > 0, name
        np.testing.assert_array_equal(tm.facets(name), ref.facets(name))
    m = tm.mesh
    np.testing.assert_array_equal(m.points, ref.mesh.points)
    pts = m.points[m.cell_vertices]
    v1, v2 = pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0]
    area = 0.5 * np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]).sum()
    assert abs(area - (4 - np.pi * 0.04 - 0.01)) < 0.05
    np.testing.assert_array_equal(mod._circumradius(m),
                                  ref_circumradius(ref.mesh))


def test_counts_and_fields_match_reference(solved):
    res, ref, _ = solved
    assert res.newton_per_step == ref.newton_per_step
    assert res.lvpp_per_step == ref.lvpp_per_step
    assert res.retries_per_step == ref.retries_per_step
    assert res.broken == ref.broken
    assert res.load_history == ref.load_history
    assert _rel(res.u, ref.u) <= 1e-8 and _rel(res.c, ref.c) <= 1e-8
    assert _rel(res.max_damage_history, ref.max_damage_history) <= 1e-8


def test_damage_and_displacement(solved):
    """tests/test_fracture.py:30-46 on the port's solution."""
    res = solved[0]
    d = res.max_damage_history
    assert all(d[i + 1] >= d[i] - 2e-2 for i in range(len(d) - 1)), d
    assert d[0] < 0.2 and d[-1] > 0.5
    assert res.c.min() > -0.05 and res.c.max() < 1.1
    assert res.u.max() > 0.5 and res.u.min() < -0.5


def test_checkpoint_from_reference_resumes_in_port(solved, tmp_path):
    """The reference's snapshot at load step 4, resumed by the port, runs
    the remaining load steps with the reference's per-step counts."""
    _, ref, ck4 = solved
    path = tmp_path / "ck.npz"
    path.write_bytes(ck4.read_bytes())
    res = mod.solve_fracture(checkpoint_path=str(path), checkpoint_every=4,
                             device="cpu", **KW)
    assert res.newton_per_step == ref.newton_per_step
    assert res.lvpp_per_step == ref.lvpp_per_step
    assert res.retries_per_step == ref.retries_per_step[4:]
    assert res.load_history == ref.load_history
    assert _rel(res.c, ref.c) <= 1e-8
    # the port's step-8 snapshot is the reference's file format
    from proximalgalerkin_tpu.utils.checkpoint import LVPPCheckpoint
    back = LVPPCheckpoint.load(path)
    assert back.step == 8 and back.newton_steps == ref.newton_per_step


class _Captured(Exception):
    pass


def _capture_problem(module, monkeypatch, **kw):
    """The model's NonlinearProblem, caught where the model hands it to
    its NewtonSolver."""
    def stop(problem, *a, **k):
        raise _Captured(problem)
    monkeypatch.setattr(module, "NewtonSolver", stop)
    with pytest.raises(_Captured) as info:
        module.solve_fracture(**kw)
    return info.value.args[0]


def test_form_matches_reference(monkeypatch):
    """Residual, element matrices (of the regularized jacobian_fn) and
    Jacobian diagonal at a random state, within 1e-12 relative."""
    kw = dict(max_res=0.5, verbose=False)
    pt = _capture_problem(mod, monkeypatch, device="cpu", **kw)
    pr = _capture_problem(ref_mod, monkeypatch, **kw)
    rng = np.random.default_rng(3)
    n = pt.space.num_dofs
    nv = pt.space.spaces["u"].num_dofs
    x = 0.5 * rng.standard_normal(n)
    coeffs = {"c_prev": 0.2 * rng.random(nv),
              "psi_iter": rng.standard_normal(nv),
              "c_iter": rng.random(nv)}
    ct = {k: torch.as_tensor(v) for k, v in coeffs.items()}
    cr = {k: jnp.asarray(v) for k, v in coeffs.items()}
    kt = {"alpha": torch.tensor(2.5, dtype=torch.float64)}
    kr = {"alpha": jnp.asarray(2.5)}
    xt, xr = torch.as_tensor(x), jnp.asarray(x)
    assert _rel(pt.form.residual(xt, ct, kt),
                pr.form.residual(xr, cr, kr)) <= 1e-12
    assert _rel(pt.form.element_matrices(xt, ct, kt),
                pr.form.element_matrices(xr, cr, kr)) <= 1e-12
    assert _rel(pt.form.jacobian_diagonal(xt, ct, kt),
                pr.form.jacobian_diagonal(xr, cr, kr)) <= 1e-12


def test_set_bc_arrays_moves_dirichlet_data():
    """NonlinearProblem.set_bc_arrays changes the device index, its host
    copy and the values together; a new set of dofs drops the ELL
    operator built on the old one."""
    from proximalgalerkin_torch.assembly import VolumeForm
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.solve import NonlinearProblem
    from proximalgalerkin_torch.spaces import (DirichletBC, FunctionSpace,
                                               MixedSpace)
    V = FunctionSpace.create(rectangle_mesh(3, 3), 1)
    space = MixedSpace([("u", V)])
    form = VolumeForm(space, lambda x, u, gu, c, gc, k: {"u": (u["u"], gu["u"])},
                      2, device="cpu")
    prob = NonlinearProblem(form, [DirichletBC.from_marker("u", V, 0.0)])
    ell = prob.ell_matrix
    idx = prob._bc_idx_host.copy()
    prob.set_bc_arrays(idx, np.full(len(idx), 2.0))
    assert prob.ell_matrix is ell
    assert float(prob.set_bc(torch.zeros(space.num_dofs))[idx].min()) == 2.0
    prob.set_bc_arrays(idx[:2], np.array([1.0, -1.0]))
    assert prob.bc_idx.tolist() == idx[:2].tolist()
    np.testing.assert_array_equal(prob._bc_idx_host, idx[:2])
    assert prob.ell_matrix is not ell


def test_cli_fracture(capsys):
    from proximalgalerkin_torch.cli import main
    from proximalgalerkin_tpu.cli import main as ref_main
    argv = ["--opt", "snes_max_it=30", "fracture", "--res", "0.4", "--Tmax",
            "0.6", "--num-load-steps", "4"]
    ref_main(argv)
    ref_last = capsys.readouterr().out.strip().splitlines()[-1]
    main(argv + ["--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == ref_last and last.startswith("steps 3 ")
    # the dof-partitioned path over 8 subdomains (the reference on its 8
    # virtual devices) from the CLI, with no load step: the distributed
    # problem is built, its state gathered back and printed; the
    # continuation's parity is test_torch_fracture_distributed.py's
    argv = ["fracture", "--res", "0.4", "--num-load-steps", "1",
            "--n-devices", "8"]
    ref_main(argv)
    ref_last = capsys.readouterr().out.strip().splitlines()[-1]
    main(argv + ["--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == ref_last == "steps 0 broken=False"
