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


# m -> (first level of the tail (len(levels): none), blocks of its
# cluster): one block from a first level of at most 65; a cluster of 16
# from the first level (at most 257) whose levels end at most at 33 and
# fit its shared memory; the grid-swept coarsest levels (67's tail is its
# level 34, 100 and 131 have none) as before
PLANS = {5: (0, 1), 9: (0, 1), 12: (0, 1), 17: (0, 1), 33: (0, 1),
         35: (0, 1), 65: (0, 1), 67: (1, 1), 97: (0, 16), 100: (1, 1),
         129: (0, 16), 131: (2, 1), 137: (0, 16), 257: (0, 16),
         289: (1, 16), 513: (1, 16), 1025: (2, 16), 2049: (3, 16)}


@pytest.mark.parametrize("m", sorted(PLANS))
def test_level_plan(m):
    ms, lt, nb = mgfused.level_plan(m)
    assert ms == mg._levels_for(m)
    assert (lt, nb) == PLANS[m]
    if lt < len(ms):
        tail = ms[lt:]
        if nb == 1:
            assert tail[0] <= 65
        else:
            assert 65 < tail[0] <= 257 and tail[-1] <= 33
            assert 0 < mgfused.cluster_levels(tail, nb) < len(tail)
            assert mgfused.tail_bytes(tail, nb) <= mgfused.MAX_SMEM
    assert all(k > 65 for k in ms[:lt])


def test_tail_sized_for_one_block():
    """A tail whose first level is at most 65 runs in one block and fits
    its dynamic shared memory (csrc/mgfused.cu tail_shape against
    MAX_SMEM): b, w, x and t of each level and a second buffer for the
    coarsest, 91 KB at 65."""
    tail = [65, 33, 17, 9, 5]
    assert mgfused.level_plan(65) == (tail, 0, 1)
    assert mgfused.cluster_levels(tail, 1) == 0
    assert mgfused.tail_bytes(tail, 1) == 4 * (
        4 * sum(k * k for k in tail) + tail[-1] ** 2) == 91444
    assert mgfused.tail_bytes(tail, 1) <= mgfused.MAX_SMEM


def test_every_tail_fits_its_blocks():
    """Every tail the plan makes, on one block or a cluster, fits each
    block's dynamic shared memory by the kernel's byte arithmetic; the
    bench size's tail is levels 257 ... 5 on 16 blocks, 17 rows of 257 in
    the largest strip (119,580 bytes; 206,044 on 8 blocks, 33 rows), and
    no cluster tail starts above 257."""
    ms, lt, nb = mgfused.level_plan(1025)
    assert (ms[lt:], nb) == ([257, 129, 65, 33, 17, 9, 5], 16)
    assert mgfused.cluster_levels(ms[lt:], nb) == 3
    block0 = 4 * (33 ** 2 + 17 ** 2 + 9 ** 2 + 5 ** 2) + 5 ** 2
    assert mgfused.tail_bytes(ms[lt:], nb) == 4 * (
        3 * 17 * 257 + 4 * 9 * 129 + 4 * 5 * 65 + 19 * 257 + block0) == 119580
    assert mgfused.tail_bytes(ms[lt:], 8) == 4 * (
        3 * 33 * 257 + 4 * 17 * 129 + 4 * 9 * 65 + 35 * 257 + block0) == 206044
    tops = set()
    for m in range(3, 4100):
        ms, lt, nb = mgfused.level_plan(m)
        if lt < len(ms):
            assert mgfused.tail_bytes(ms[lt:], nb) <= mgfused.MAX_SMEM
            if nb > 1:
                tops.add(ms[lt])
    assert max(tops) == 257


@pytest.mark.parametrize("m", [5, 9, 12, 17, 33, 35, 65, 67, 97, 100, 129,
                               131, 137, 257, 289, 513, 1025])
def test_plan_split_is_the_plain_vcycle(m):
    """The kernel's split of the V-cycle (down legs, the tail or the
    coarsest sweeps, up legs), in its plain pieces, gives the bits of
    the plain V-cycle with the same transfers; up to m = 513, where
    ops/mg's matrix products split no sum on the CPU, those of
    pc_reference too."""
    alpha, b, B, C, whier = grids(m, seed=2)
    z = mgfused.pc_by_plan_reference(b, B, whier, alpha)
    assert torch.equal(z, mgfused._pc_split(b, B, whier, alpha, 0))
    if m <= 513:
        assert torch.equal(z, mgfused.pc_reference(b, B, whier, alpha))


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

    def __init__(self, capture_err=0, launch_err=0, create_err=0):
        self.capture_err, self.launch_err = capture_err, launch_err
        self.create_err = create_err
        self.captures, self.launches, self.destroyed = [], [], []
        self.created = []

    def mgf_ws_floats(self, m, lt, nb):
        return -1 if lt < 0 else 7 * 2 * m * m + 64

    def mgf_ws_create(self, m, lt, nb, fbase, cnt, err):
        if self.create_err:
            err._obj.value = self.create_err
            return None
        self.m = m
        self.created.append((m, lt, nb))
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
    ws = mgfused._Workspace(lib, M, 0, 1, torch.device("cpu"))
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
        mgfused._Workspace(FakeLib(), M, -1, 1, torch.device("cpu"))
    ws = mgfused._Workspace(FakeLib(capture_err=2), M, 0, 1,
                            torch.device("cpu"))
    with pytest.raises(RuntimeError, match="mgf_capture: CUDA error 2"):
        ws.launch(64, True, 0)
    ws = mgfused._Workspace(FakeLib(launch_err=700), M, 0, 1,
                            torch.device("cpu"))
    with pytest.raises(RuntimeError, match="mgf_launch: CUDA error 700"):
        ws.launch(64, True, 0)


def test_workspace_refuses_a_card_without_the_cluster(monkeypatch):
    """Where the card holds no cluster of the tail (the kernel's occupancy
    query at workspace creation), making the workspace raises; there is
    no other path."""
    lib = FakeLib(create_err=-2)
    monkeypatch.setattr(mgfused, "_lib", lambda: lib)
    monkeypatch.setattr(mgfused, "_workspaces", {})
    with pytest.raises(RuntimeError, match="mgf_ws_create: CUDA error -2"):
        mgfused._workspace(1025, torch.device("cpu"))
    assert mgfused._workspaces == {}


def test_workspace_cache_is_per_m_and_split(monkeypatch):
    """One workspace per (device, m), made with the tail split and the
    cluster of level_plan."""
    lib = FakeLib()
    monkeypatch.setattr(mgfused, "_lib", lambda: lib)
    monkeypatch.setattr(mgfused, "_workspaces", {})
    cpu = torch.device("cpu")
    a = mgfused._workspace(35, cpu)
    assert mgfused._workspace(35, cpu) is a
    assert mgfused._workspace(33, cpu) is not a
    mgfused._workspace(129, cpu)
    mgfused._workspace(131, cpu)
    assert lib.created == [(35, 0, 1), (33, 0, 1), (129, 0, 16),
                           (131, 2, 1)]
    assert sorted(m for _, m in mgfused._workspaces) == [33, 35, 129, 131]
    mgfused.release_workspaces()
    assert mgfused._workspaces == {}
    assert 77 in lib.destroyed


@pytest.mark.parametrize("m, nb, its", [(129, 16, 17), (33, 1, 17)])
def test_cluster_tail_counter(monkeypatch, m, nb, its):
    """A solve whose workspace has a cluster tail adds its CG iterations
    to the counter mgpcg.cluster_tail_its; a one-block tail adds none."""
    from proximalgalerkin_torch.core.logging import counter
    lib = FakeLib()
    monkeypatch.setattr(mgfused, "_lib", lambda: lib)
    monkeypatch.setattr(mgfused, "_workspaces", {})
    monkeypatch.setattr(mgfused._nvcc, "stream_of", lambda t: 0)
    alpha, b, B, C, whier = grids(m)
    ws = mgfused._workspace(m, b.device)
    assert ws.nb == nb
    ws.sc[mgfused._SC_IT] = its    # the stand-in's solve: done, `its` long
    before = counter("mgpcg.cluster_tail_its")
    _, got = mgfused._kernel_solve(b, B, C, whier, alpha, 1e-6, 500, 64)
    assert got == its
    assert counter("mgpcg.cluster_tail_its") - before == (
        its if nb > 1 else 0)


def test_every_kernel_is_seen_by_the_roofline():
    """Every __global__ kernel of csrc/mgfused.cu matches the regex by
    which the benchmark's mgpcg_roofline finds the kernel's device time,
    as the profiler names it, so that no MG-PCG launch drops out of it."""
    import re
    from pathlib import Path
    from pgbench.metrics.mgpcg_roofline import KERNELS
    src = (Path(mgfused.__file__).parents[1] / "csrc"
           / "mgfused.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src)
    assert "k_tail" in names and len(names) >= 11
    for name in names:
        assert KERNELS.search(f"(anonymous namespace)::{name}(float const*, "
                              "int)"), name


@pytest.mark.parametrize("m", [5, 9, 17, 33, 65, 129, 257, 513])
def test_pointwise_transfers_are_the_matrix_products(m):
    """The plain version's restriction and prolongation, written point by
    point in the kernel's order, give the bits of ops/mg's matrix products
    here on the CPU up to m = 513 (beyond, a product may split a sum),
    and restrict/prolong are each other's transpose up to the factor 4."""
    g = torch.Generator().manual_seed(m)
    f = torch.randn((m, m), generator=g) * torch.exp(
        8 * torch.randn((m, m), generator=g))
    mc = (m - 1) // 2 + 1
    e = torch.randn((mc, mc), generator=g)
    assert torch.equal(mgfused.restrict_pointwise(f), mg.restrict(f))
    assert torch.equal(mgfused.prolong_pointwise(e), mg.prolong(e))
    d = f / f.abs().max()
    lhs = float((mgfused.restrict_pointwise(d) * e).sum(dtype=torch.float64))
    rhs = float((d * mgfused.prolong_pointwise(e)).sum(dtype=torch.float64))
    assert abs(4 * lhs - rhs) <= 1e-5 * (abs(rhs) + 1)
