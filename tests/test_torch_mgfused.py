"""The port's fused MG-PCG (ops/mgfused.py). On the CPU the solve takes
its plain PyTorch version, held here against the reference: JAX
ops/mg.pcg and the JAX FusedMgCg kernel in Pallas interpret mode, at
m = 33 on the deep-contact Schur state. The CUDA kernel itself runs only
on the card (tests/test_torch_gpu.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.ops import mg as ref_mg
from proximalgalerkin_tpu.ops.mgfused import (FusedMgCg, pad_to_grid,
                                              unpad_from_grid)

from proximalgalerkin_torch.ops import mg, mgfused

from chip_smoke import deep_contact_state, grids_on

M = 33
f32 = torch.float32


def grids(m, seed=0):
    """(alpha, b, B, C, whier) as (m, m) f32 CPU tensors for the port."""
    return grids_on(torch.device("cpu"), m, seed)


def _ref_pcg(m, b, seed=0, tol=1e-6, maxiter=500):
    """The reference's XLA MG-PCG on the same state, as its
    test_mgfused.py drives it."""
    alpha, free, B, C, w0, _, sq = deep_contact_state(m, seed)
    B32, C32 = jnp.asarray(B), jnp.asarray(C)
    free32 = jnp.asarray(free.astype(np.float32))

    def S32t(vt):
        y5 = ref_mg.k5_apply((B32 * vt).reshape(m, m)).reshape(-1)
        return jnp.float32(alpha) * B32 * (free32 * y5) + C32 * vt

    mgpc = ref_mg.make_mg_pc(m)(jnp.asarray(alpha, jnp.float32),
                                jnp.asarray(w0))
    sq32 = jnp.asarray(np.where(free, sq, 1.0), jnp.float32)
    x, its = ref_mg.pcg(S32t, jnp.asarray(b), lambda r:
                        sq32 * free32 * mgpc(sq32 * r), tol, maxiter)
    return np.asarray(x), int(its), S32t


def test_plain_matches_reference_pcg_and_fused_kernel():
    tol, maxiter = 1e-6, 500
    alpha, b, B, C, whier = grids(M)
    xt, itt = mgfused.solve(b, B, C, whier, alpha, tol, maxiter)
    xt = xt.reshape(-1).numpy()
    assert itt > 0

    xr, itr, S32t = _ref_pcg(M, b.reshape(-1).numpy())
    assert abs(itt - itr) <= 3
    assert np.linalg.norm(xt - xr) <= 1e-4 * np.linalg.norm(xr)
    bn = np.linalg.norm(b.numpy())
    assert np.linalg.norm(b.numpy().reshape(-1)
                          - np.asarray(S32t(jnp.asarray(xt)))) < 5 * tol * bn

    # the reference's Pallas kernel in interpret mode (padded grids)
    fu = FusedMgCg(M, chunk=64, interpret=True)
    pad = [pad_to_grid(jnp.asarray(w.reshape(-1).numpy()), w.shape[0])
           for w in whier]
    xf, itf = fu.solve(*(pad_to_grid(jnp.asarray(v.reshape(-1).numpy()), M)
                         for v in (b, B, C)), pad, alpha, tol, maxiter)
    xf = np.asarray(unpad_from_grid(xf, M))
    assert abs(itt - int(itf)) <= 3
    assert np.linalg.norm(xt - xf) <= 1e-4 * np.linalg.norm(xf)


def test_chunk_boundaries_do_not_change_result():
    alpha, b, B, C, whier = grids(M, seed=3)
    x64, i64 = mgfused.solve(b, B, C, whier, alpha, 1e-6, 500, chunk=64)
    x5, i5 = mgfused.solve(b, B, C, whier, alpha, 1e-6, 500, chunk=5)
    assert i64 == i5 > 0
    assert torch.equal(x64, x5)


def test_maxiter_is_respected():
    alpha, b, B, C, whier = grids(M, seed=1)
    _, its = mgfused.solve(b, B, C, whier, alpha, 1e-30, maxiter=7,
                           chunk=3)
    assert its == 7


def test_zero_rhs_returns_zero_after_no_iterations():
    """A zero right-hand side returns at once (the reference's fused
    driver would loop forever here; ops/mg.pcg returns 0 iterations)."""
    alpha, b, B, C, whier = grids(M)
    x, its = mgfused.solve(torch.zeros_like(b), B, C, whier, alpha, 1e-6,
                           500)
    _, itr, _ = _ref_pcg(M, np.zeros(M * M, np.float32))
    assert its == itr == 0
    assert float(x.abs().max()) == 0.0


def test_plain_pieces_match_mg_module():
    alpha, b, B, C, whier = grids(M)
    z = mgfused.pc_reference(b, B, whier, alpha)
    sqf = B * (4.0 * torch.tensor(np.float32(alpha)) + whier[0])
    pc = mg.make_mg_pc(M)(np.float32(alpha), whier[0].reshape(-1))
    assert torch.equal(z.reshape(-1), sqf.reshape(-1)
                       * pc((sqf * b).reshape(-1)))
    Ap = mgfused.matvec_reference(b, B, C, alpha)
    assert Ap.shape == (M, M) and Ap.dtype == f32


@pytest.mark.parametrize("bad", ["dtype", "shape", "levels", "layout"])
def test_solve_rejects_bad_inputs(bad):
    alpha, b, B, C, whier = grids(M)
    if bad == "dtype":
        B = B.double()
    elif bad == "shape":
        C = C[:-1]
    elif bad == "levels":
        whier = whier[:-1]
    else:
        b = b.t()
    with pytest.raises((TypeError, ValueError)):
        mgfused.solve(b, B, C, whier, alpha, 1e-6, 10)


def test_kernel_entry_points_refuse_cpu_tensors():
    alpha, b, B, C, whier = grids(M)
    with pytest.raises(ValueError, match="CUDA"):
        mgfused.kernel_matvec(b, B, C, alpha)
    with pytest.raises(ValueError, match="CUDA"):
        mgfused.kernel_pc(b, B, whier, alpha)
    with pytest.raises(ValueError, match="CUDA"):
        mgfused.kernel_matvec_update(b, b, B, C, whier[0], alpha, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        mgfused.kernel_down(b, whier[0], alpha)
    with pytest.raises(ValueError, match="CUDA"):
        mgfused.kernel_up(b, whier[0], whier[1], alpha)


# m -> first level of the one-block tail (len(levels): none)
PLANS = {5: 0, 9: 0, 12: 0, 17: 0, 33: 0, 35: 0, 65: 0, 67: 1, 100: 1,
         129: 1, 131: 2, 257: 2, 513: 3, 1025: 4, 2049: 5}


@pytest.mark.parametrize("m", sorted(PLANS))
def test_level_plan(m):
    ms, lt = mgfused.level_plan(m)
    assert ms == mg._levels_for(m)
    assert lt == PLANS[m]
    if lt < len(ms):
        assert ms[lt] <= 65
    assert all(k > 65 for k in ms[:lt])


def test_tail_sized_for_one_block():
    """The bench size's tail is levels 65 ... 5, and every tail the plan
    makes fits one block's dynamic shared memory (csrc/mgfused.cu
    tail_bytes against MAX_SMEM)."""
    ms, lt = mgfused.level_plan(1025)
    assert ms[lt:] == [65, 33, 17, 9, 5]
    for m in range(3, 4100):
        ms, lt = mgfused.level_plan(m)
        if lt < len(ms):
            tail = ms[lt:]
            assert 4 * (4 * sum(k * k for k in tail) + tail[-1] ** 2) \
                <= 232448 - 1024


@pytest.mark.parametrize("m", [5, 9, 12, 17, 33, 35, 65, 67, 100, 129,
                               131, 257, 513, 1025])
def test_plan_split_is_the_plain_vcycle(m):
    """The kernel's split of the V-cycle (down legs, the tail or the
    coarsest sweeps, up legs), in its plain pieces, gives the bits of
    the plain V-cycle."""
    alpha, b, B, C, whier = grids(m, seed=2)
    assert torch.equal(mgfused.pc_by_plan_reference(b, B, whier, alpha),
                       mgfused.pc_reference(b, B, whier, alpha))


def test_matvec_step_reference():
    """p' = sqf t0 + beta p; with t0 = 0 and beta = 1 the step is S p."""
    alpha, b, B, C, whier = grids(M)
    zero = torch.zeros_like(b)
    pn, Ap = mgfused.matvec_update_reference(zero, b, B, C, zero, alpha,
                                             1.0)
    assert torch.equal(pn, b)
    assert torch.equal(Ap, mgfused.matvec_reference(b, B, C, alpha))
    t0 = whier[0] / whier[0].max()
    pn, _ = mgfused.matvec_update_reference(t0, b, B, C, whier[0], alpha,
                                            0.5)
    sqf = B * (4.0 * torch.tensor(np.float32(alpha)) + whier[0])
    assert torch.equal(pn, sqf * t0 + torch.tensor(np.float32(0.5)) * b)


class FakeLib:
    """Stands in for the kernel library on the CPU: records captures and
    launches, fails where asked."""

    def __init__(self, capture_err=0, launch_err=0):
        self.capture_err, self.launch_err = capture_err, launch_err
        self.captures, self.launches, self.destroyed = [], [], []
        self.created = []

    def mgf_ws_floats(self, m, lt):
        return -1 if lt < 0 else 7 * 2 * m * m + 64

    def mgf_ws_create(self, m, lt, fbase, cnt, err):
        self.m = m
        self.created.append((m, lt))
        return 77

    def mgf_ws_offset(self, handle, slot):
        return slot * 2 * self.m * self.m

    def mgf_capture(self, handle, chunk, first, err):
        if self.capture_err:
            err._obj.value = self.capture_err
            return None
        self.captures.append((chunk, first))
        return 1000 + len(self.captures)

    def mgf_launch(self, graph, stream):
        self.launches.append(graph)
        return self.launch_err

    def mgf_error_string(self, err):
        return b"stand-in error"

    def mgf_graph_destroy(self, graph):
        self.destroyed.append(graph)

    def mgf_ws_destroy(self, handle):
        self.destroyed.append(handle)


def test_workspace_captures_each_chunk_graph_once():
    lib = FakeLib()
    ws = mgfused._Workspace(lib, M, 0, torch.device("cpu"))
    assert ws.B.numel() == ws.XB.numel() == M * M and ws.sc.numel() == 32
    for chunk, first in ((64, True), (64, False), (64, False), (5, True),
                         (64, True), (5, False)):
        ws.launch(chunk, first, 0)
    assert lib.captures == [(64, 1), (64, 0), (5, 1), (5, 0)]
    assert lib.launches == [1001, 1002, 1002, 1003, 1001, 1004]
    assert mgfused._graph_key(64, 1) == mgfused._graph_key(64.0, True)
    ws.set_params(37.0, 1e-6, 500)
    assert ws.sc[mgfused._SC_ALPHA:mgfused._SC_ALPHA + 3].tolist() == [
        37.0, float(np.float32(1e-6)), 500.0]
    ws.close()
    assert sorted(lib.destroyed) == [77, 1001, 1002, 1003, 1004]


def test_workspace_failures_raise():
    with pytest.raises(ValueError, match="no workspace"):
        mgfused._Workspace(FakeLib(), M, -1, torch.device("cpu"))
    ws = mgfused._Workspace(FakeLib(capture_err=2), M, 0,
                            torch.device("cpu"))
    with pytest.raises(RuntimeError, match="mgf_capture: CUDA error 2"):
        ws.launch(64, True, 0)
    ws = mgfused._Workspace(FakeLib(launch_err=700), M, 0,
                            torch.device("cpu"))
    with pytest.raises(RuntimeError, match="mgf_launch: CUDA error 700"):
        ws.launch(64, True, 0)


def test_workspace_cache_is_per_m_and_split(monkeypatch):
    """One workspace per (device, m), made with the tail split of
    level_plan."""
    lib = FakeLib()
    monkeypatch.setattr(mgfused, "_lib", lambda: lib)
    monkeypatch.setattr(mgfused, "_workspaces", {})
    cpu = torch.device("cpu")
    a = mgfused._workspace(35, cpu)
    assert mgfused._workspace(35, cpu) is a
    assert mgfused._workspace(33, cpu) is not a
    mgfused._workspace(129, cpu)
    mgfused._workspace(131, cpu)
    assert lib.created == [(35, 0), (33, 0), (129, 1), (131, 2)]
    assert sorted(m for _, m in mgfused._workspaces) == [33, 35, 129, 131]
    mgfused.release_workspaces()
    assert mgfused._workspaces == {}
    assert 77 in lib.destroyed
