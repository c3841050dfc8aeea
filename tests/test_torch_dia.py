"""The port's DIA SpMV (ops/dia_spmv.py) and fused DIA-CG (ops/dia_cg.py)
on the CPU, where they take their plain PyTorch versions, held against
the reference's Pallas kernels in interpret mode (the goldens of
tests/test_pallas_ops.py) and its assembled operators. The CUDA kernels
themselves run only on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proximalgalerkin_tpu.mesh import rectangle_mesh as ref_rectangle_mesh
from proximalgalerkin_tpu.models.obstacle_p1 import \
    P1ObstacleSolver as RefSolver
from proximalgalerkin_tpu.ops import dia_spmv_pallas
from proximalgalerkin_tpu.ops.pallas_cg import make_fused_dia_cg

from proximalgalerkin_torch.la.dia import DiaMatrix
from proximalgalerkin_torch.models.obstacle_p1 import effective_dia
from proximalgalerkin_torch.ops import dia_cg
from proximalgalerkin_torch.ops.dia_spmv import dia_spmv, dia_spmv_reference

from chip_smoke import spd_dia_system

f32, f64 = torch.float32, torch.float64


def _ref_operator(nx, ny):
    s = RefSolver(ref_rectangle_mesh(nx, ny, p0=(-1, -1), p1=(1, 1)))
    assert s.dia is not None
    return s.dia.offsets, np.array(s.dia.data), s.N


def test_spmv_matches_pallas_golden_f64():
    """tests/test_pallas_ops.py:12: 24^2, f64, within 1e-12."""
    offsets, data, n = _ref_operator(24, 24)
    x = np.random.default_rng(0).normal(size=n)
    y_pl = np.asarray(dia_spmv_pallas(offsets, jnp.asarray(data),
                                      jnp.asarray(x), block=256,
                                      interpret=True))
    y = dia_spmv(offsets, torch.as_tensor(data), torch.as_tensor(x))
    assert y.dtype == f64
    assert np.abs(y.numpy() - y_pl).max() <= 1e-12


def test_spmv_matches_pallas_golden_f32_blocks():
    """tests/test_pallas_ops.py:24: 17x13, f32, blocks of uneven size;
    within 1e-6 relative."""
    offsets, data, n = _ref_operator(17, 13)
    d32 = data.astype(np.float32)
    x = np.random.default_rng(1).normal(size=n).astype(np.float32)
    y_pl = np.asarray(dia_spmv_pallas(offsets, jnp.asarray(d32),
                                      jnp.asarray(x), block=64,
                                      interpret=True))
    y = dia_spmv(offsets, torch.as_tensor(d32), torch.as_tensor(x))
    assert y.dtype == f32
    assert np.abs(y.numpy() - y_pl).max() <= 1e-6 * np.abs(y_pl).max()


def test_dia_matrix_spmv_is_the_op():
    offsets, data, n = _ref_operator(12, 9)
    A = DiaMatrix(offsets=offsets, data=torch.as_tensor(data), n=n)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=n))
    assert torch.equal(A.spmv(x), dia_spmv_reference(offsets, A.data, x))
    d32, x32 = A.data.to(f32), x.to(f32)
    assert torch.equal(A.spmv(x32, d32),
                       dia_spmv_reference(offsets, d32, x32))


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "vector",
                                 "device", "layout", "diagonals"])
def test_spmv_rejects_bad_inputs(bad):
    offsets, data, n = _ref_operator(8, 8)
    d = torch.as_tensor(data)
    x = torch.ones(n, dtype=f64)
    if bad == "dtype":
        d, x = d.to(torch.float16), x.to(torch.float16)
    elif bad == "mixed":
        d = d.to(f32)
    elif bad == "shape":
        d = d[:, :-1]
    elif bad == "vector":
        x = x.reshape(1, n)
    elif bad == "device":
        d = d.to("meta")
    elif bad == "layout":
        d = torch.as_tensor(np.asfortranarray(data))
    else:
        offsets = ()
    with pytest.raises((TypeError, ValueError)):
        dia_spmv(offsets, d, x)


def test_plain_fused_cg_matches_pallas_golden():
    """tests/test_pallas_ops.py:36: the random SPD 7-diagonal system, f64:
    the plain version and the reference's interpret-mode kernels both
    within 1e-9 of the dense solve, in the same number of iterations."""
    offsets, data, b, x_ref = spd_dia_system(800, 25, seed=0)
    x, its = dia_cg.solve(offsets, torch.as_tensor(data),
                          torch.as_tensor(b), 1e-12, 500)
    fused = make_fused_dia_cg(offsets, 800, dtype=jnp.float64,
                              interpret=True)
    xr, itr = fused(jnp.asarray(data), jnp.asarray(b), 1e-12, 500)
    xn = np.linalg.norm(x_ref)
    assert np.linalg.norm(x.numpy() - x_ref) < 1e-9 * xn
    assert np.linalg.norm(np.asarray(xr) - x_ref) < 1e-9 * xn
    assert 0 < its < 100
    assert its == int(itr)


def _cg_system(seed=0):
    offsets, data, b, _ = spd_dia_system(800, 25, seed=seed)
    return offsets, torch.as_tensor(data, dtype=f32), torch.as_tensor(
        b, dtype=f32)


def test_chunk_boundaries_do_not_change_result():
    offsets, data, b = _cg_system(3)
    x64, i64 = dia_cg.solve(offsets, data, b, 1e-6, 500, chunk=64)
    x1, i1 = dia_cg.solve(offsets, data, b, 1e-6, 500, chunk=1)
    x7, i7 = dia_cg.solve(offsets, data, b, 1e-6, 500, chunk=7)
    assert i64 == i1 == i7 > 0
    assert torch.equal(x64, x1) and torch.equal(x64, x7)


def test_maxiter_is_respected():
    offsets, data, b = _cg_system(1)
    _, its = dia_cg.solve(offsets, data, b, 1e-30, maxiter=7, chunk=3,
                          stall_guard=0.0)
    assert its == 7
    _, its0 = dia_cg.solve(offsets, data, b, 1e-6, maxiter=0)
    assert its0 == 0


def test_zero_rhs_returns_zero_after_no_iterations():
    offsets, data, b = _cg_system()
    x, its = dia_cg.solve(offsets, data, torch.zeros_like(b), 1e-6, 500)
    assert its == 0
    assert float(x.abs().max()) == 0.0


def test_stall_exit_returns_the_best_iterate():
    """An unreachable f32 tolerance: the stall exit fires before maxiter
    and the returned iterate has the smallest residual seen."""
    offsets, data, b = _cg_system(2)
    x, its = dia_cg.solve(offsets, data, b, 1e-12, 5000)
    assert 0 < its < 5000
    r = b - dia_spmv_reference(offsets, data, x)
    assert float(torch.linalg.norm(r)) < 1e-5 * float(torch.linalg.norm(b))


def test_ordered_sum_and_pieces():
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.normal(size=300_000))
    assert abs(float(dia_cg.ordered_sum(v)) - float(v.sum())) < 1e-9
    offsets, data, b = _cg_system()
    p = torch.as_tensor(rng.normal(size=800), dtype=f32)
    pn, Ap, part = dia_cg.k1_reference(offsets, data, b, p, 0.5)
    assert torch.equal(pn, b + 0.5 * p)
    assert torch.equal(Ap, dia_spmv_reference(offsets, data, pn))
    assert part.shape == (4,)
    x, r, part = dia_cg.k2_reference(p, b, pn, Ap, 0.25)
    assert torch.equal(r, b - 0.25 * Ap) and part.shape == (4,)


def test_effective_dia_matches_numpy_rebuild():
    """effective_dia against a numpy rebuild of the reference's data_eff
    (models/obstacle_p1.py:576-597) on a seeded state: exact."""
    offsets, data, n = _ref_operator(16, 16)
    rng = np.random.default_rng(5)
    A32 = data.astype(np.float32)
    free = rng.random(n) < 0.7
    sqinv32 = (1.0 / np.sqrt(1.0 + 100.0 * rng.random(n))).astype(
        np.float32)
    m2d32 = np.where(free, 10.0 ** rng.uniform(-2, 8, n), 0.0).astype(
        np.float32)
    alpha32 = np.float32(37.25)

    fs = np.where(free, sqinv32, np.float32(0.0))
    rows = []
    for k, off in enumerate(offsets):
        sh = np.zeros_like(fs)
        if off >= 0:
            sh[:n - off] = fs[off:]
        else:
            sh[-off:] = fs[:n + off]
        row = fs * alpha32 * A32[k] * sh
        if off == 0:
            row = (row + m2d32 * sqinv32 * sqinv32
                   + np.where(free, 0.0, 1.0).astype(np.float32)
                   * sqinv32 * sqinv32)
        rows.append(row)
    want = np.stack(rows)

    got = effective_dia(offsets, torch.as_tensor(A32), torch.as_tensor(free),
                        torch.as_tensor(sqinv32), torch.as_tensor(m2d32),
                        float(alpha32))
    assert got.dtype == f32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "chunk"])
def test_solve_rejects_bad_inputs(bad):
    offsets, data, b = _cg_system()
    chunk = 64
    if bad == "dtype":
        data = data.double()
    elif bad == "shape":
        b = b[:-1]
    elif bad == "device":
        data = data.to("meta")
    else:
        chunk = 0
    with pytest.raises((TypeError, ValueError)):
        dia_cg.solve(offsets, data, b, 1e-6, 10, chunk=chunk)


def test_kernel_entry_points_refuse_cpu_tensors():
    offsets, data, b = _cg_system()
    with pytest.raises(ValueError, match="CUDA"):
        dia_cg.kernel_k1(offsets, data, b, b, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        dia_cg.kernel_k2(offsets, b, b, b, b, 0.5)


# ------------------------------------ the kernels' host side, on the CPU

P1_OFFSETS = (-1026, -1025, -1, 0, 1, 1025, 1026)


@pytest.mark.parametrize("offsets, clusters, member", [
    (P1_OFFSETS, ((-1026, -1025), (-1, 1), (1025, 1026)),
     (0, 0, 1, 1, 1, 2, 2)),
    ((-5000, -300, 0, 77, 900), (), (-1, -1, -1, -1, -1)),
    ((0,), (), (-1,)),
    # unsorted, and a gap of exactly the limit joins while one more splits
    ((40, 0, 8, 73, -500), ((0, 40),), (0, 0, 0, -1, -1)),
    ((0, 32, 64, 97), ((0, 64),), (0, 0, 0, -1)),
])
def test_cluster_offsets(offsets, clusters, member):
    assert dia_cg.cluster_offsets(offsets) == (clusters, member)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_stage_plan_of_the_p1_stencil(itemsize):
    """Bands of four runs; the cluster of three diagonals first, then the
    pairs. Each segment starts on a multiple of four rows at or below its
    lowest offset and covers the band under every offset of its cluster;
    a stage of the ring is 53 KB in f32, so two blocks of two stages fit
    an SM."""
    plan = dia_cg.stage_plan(P1_OFFSETS, itemsize)
    assert (plan.runs, plan.stages) == (4, 2)
    assert plan.member == (1, 1, 0, 0, 0, 2, 2)
    assert plan.start == (-4, -1028, 1024)
    assert plan.length == (1032, 1028, 1028)
    for d, off in enumerate(P1_OFFSETS):
        c = plan.member[d]
        assert plan.start[c] % 4 == 0 and plan.length[c] % 4 == 0
        assert plan.start[c] <= off
        assert 1024 + off <= plan.start[c] + plan.length[c]
    values = dia_cg.stage_values(7, plan.runs, sum(plan.length))
    assert values == 7 * 1024 + 2 * 3088 and values * 4 == 53376
    smem = dia_cg.k1_smem_bytes(7, plan, itemsize)
    assert smem == (1024 + 2 * values) * itemsize <= dia_cg._K1_SMEM
    if itemsize == 4:
        assert 2 * smem <= dia_cg._K1_SMEM      # two blocks an SM


def test_stage_plan_leaves_out_what_does_not_fit():
    """Ten clusters of two: the first eight are staged (the kernel's
    limit), the rest read through the cache. Where the matrix rows of a
    four-run band are too many for two stages the band is one run, in two
    stages or, with more diagonals still, in one; a cluster that would
    push the ring past the shared memory of a block is not staged."""
    smem = dia_cg.k1_smem_bytes
    offsets = tuple(o for k in range(10) for o in (5000 * k, 5000 * k + 1))
    plan = dia_cg.stage_plan(offsets, 4)
    assert (plan.runs, plan.stages) == (4, 2)   # 80 KB of matrix rows a stage
    assert plan.member == tuple(c if c < 3 else -1
                                for c in range(10) for _ in range(2))
    assert smem(20, plan, 4) <= dia_cg._K1_SMEM
    assert smem(20, plan, 4) + 2 * 2 * 1028 * 4 > dia_cg._K1_SMEM
    plan = dia_cg.stage_plan(offsets, 8)
    assert (plan.runs, plan.stages) == (1, 2)
    assert plan.member == tuple(c if c < 8 else -1
                                for c in range(10) for _ in range(2))
    many = tuple(range(0, 30 * 64, 30))         # one cluster of 64
    wide = dia_cg.stage_plan(many, 8)
    assert (wide.runs, wide.stages) == (1, 1) and set(wide.member) == {0}
    assert wide.length == (256 + 1892,)
    assert smem(64, wide, 8) <= dia_cg._K1_SMEM
    far = dia_cg.stage_plan(tuple(range(0, 300 * 64, 300)), 8)
    assert far.runs == 1 and set(far.member) == {-1} and far.length == ()
    mid = dia_cg.stage_plan(tuple(range(0, 30 * 20, 30)), 8)
    assert (mid.runs, mid.stages) == (1, 2) and mid.length == (256 + 572,)
    few = dia_cg.stage_plan(tuple(range(0, 30 * 8, 30)), 8)
    assert (few.runs, few.stages) == (4, 2) and few.length == (1024 + 212,)
    for nd, plan in ((64, far), (20, mid), (8, few)):
        assert smem(nd, plan, 8) <= dia_cg._K1_SMEM


def _k1_banded(offsets, data, r, p, beta):
    """K1's Ap computed as csrc/dia.cu k_k1 indexes it: bands of the
    plan's runs, r and p staged per cluster segment in groups of four
    rows from buffers padded with NaN, clipped to the matrix; unstaged
    diagonals read from r and p."""
    n = r.shape[0]
    plan = dia_cg.stage_plan(offsets, r.element_size())
    npad = dia_cg._padded(n)
    nan = torch.full((npad - n,), float("nan"), dtype=r.dtype)
    rp, pp = torch.cat([r, nan]), torch.cat([p, nan])
    Ap = torch.zeros_like(r)
    band = plan.runs * dia_cg._TPB
    for s0 in range(0, n, band):
        rows = torch.arange(s0, min(s0 + band, n))
        segs = []
        for start, length in zip(plan.start, plan.length):
            sr = torch.full((length,), float("nan"), dtype=r.dtype)
            sp = sr.clone()
            for k in range(0, length, 4):
                j = s0 + start + k
                if 0 <= j < n:
                    sr[k:k + 4], sp[k:k + 4] = rp[j:j + 4], pp[j:j + 4]
            segs.append((sr, sp))
        acc = torch.zeros(len(rows), dtype=r.dtype)
        for d, off in enumerate(offsets):
            j = rows + off
            ok = (j >= 0) & (j < n)
            c = plan.member[d]
            if c >= 0:
                q = (rows - s0 + off - plan.start[c])[ok]
                v = segs[c][0][q] + beta * segs[c][1][q]
            else:
                v = r[j[ok]] + beta * p[j[ok]]
            acc[ok] = acc[ok] + data[d, rows[ok]] * v
        Ap[rows] = acc
    return Ap


@pytest.mark.parametrize("dtype", [f32, f64])
@pytest.mark.parametrize("n, offsets", [
    (33 * 33, (-34, -33, -1, 0, 1, 33, 34)),       # a ragged second band
    (2 * 1024 + 5, (-34, -33, -1, 0, 1, 33, 34)),  # five rows in the last
    (3 * 1024, (-1026, -1025, -1, 0, 1, 1025, 1026)),
    (700, tuple(range(-300, 340, 10))),            # 64 diagonals: one run
    (2500, (-700, -2, 0, 3, 1200)),                # a cluster and singles
    (1500, (-900, -100, 0, 250, 1300)),            # nothing clusters
])
def test_banded_k1_indexing_matches_plain(dtype, n, offsets):
    """The staging plan reaches every neighbour a row needs and nothing
    outside the matrix: K1 indexed as the kernel does it gives the plain
    version's bits (NaN anywhere would show a value read out of range)."""
    rng = np.random.default_rng(n)
    data = torch.as_tensor(rng.normal(size=(len(offsets), n)), dtype=dtype)
    r = torch.as_tensor(rng.normal(size=n), dtype=dtype)
    p = torch.as_tensor(rng.normal(size=n), dtype=dtype)
    beta = torch.tensor(0.375, dtype=dtype)
    _, Ap, _ = dia_cg.k1_reference(offsets, data, r, p, beta)
    assert torch.equal(_k1_banded(offsets, data, r, p, beta), Ap)


def test_ordered_sum_bits_are_pinned():
    """The summation order is part of the contract between kernel and
    plain version (and fixes the solver's CG counts): 256-entry runs in
    index order, a halving tree over each, 1,024 strided running sums
    over the runs' partials, a tree over those. These are the bits of
    that order on a seeded vector; another order gives others."""
    v = np.random.default_rng(7).normal(size=300_001)
    s32 = dia_cg.ordered_sum(torch.as_tensor(v, dtype=f32))
    s64 = dia_cg.ordered_sum(torch.as_tensor(v, dtype=f64))
    assert float(s32).hex() == ORDERED_SUM_F32
    assert float(s64).hex() == ORDERED_SUM_F64
    assert float(torch.as_tensor(v, dtype=f32).sum()).hex() != ORDERED_SUM_F32


ORDERED_SUM_F32 = "0x1.8d28280000000p+6"
ORDERED_SUM_F64 = "0x1.8d2832753e8e6p+6"


class FakeDiaLib:
    """Stands in for the kernel library on the CPU: records workspaces,
    captures and launches, fails where asked. on_launch(graph) is called
    at every launch (a test uses it to play the device's part)."""

    def __init__(self, create_err=0, capture_err=0, launch_err=0,
                 smem_off=0):
        self.create_err, self.capture_err = create_err, capture_err
        self.launch_err, self.smem_off = launch_err, smem_off
        self.created, self.captures, self.launches = [], [], []
        self.destroyed = []
        self.on_launch = None

    def dcg_ws_create(self, f64, n, pitch, npad, nd, offs, cl, nc, start,
                      length, runs, stages, data, vec, part, sc, cnt, err):
        if self.create_err:
            err._obj.value = self.create_err
            return None
        self.created.append((f64, n, nd))
        self.pointers = (data, vec, part, sc)
        self.geometry = (pitch, npad, runs, stages, nc, list(cl),
                         list(start), list(length))
        # K1's dynamic shared memory as csrc/dia.cu k1_smem lays it out
        stage = nd * runs * 256 + 2 * sum(length)
        self.smem = (runs * 256 + stages * stage) * (8 if f64 else 4)
        return 55

    def dcg_ws_info(self, handle, grid, smem):
        grid._obj.value = 132
        smem._obj.value = self.smem + self.smem_off

    def dcg_capture(self, handle, chunk, first, err):
        if self.capture_err:
            err._obj.value = self.capture_err
            return None
        self.captures.append((chunk, first))
        return 2000 + len(self.captures)

    def dcg_launch(self, graph, stream):
        self.launches.append(graph)
        if self.on_launch is not None:
            self.on_launch(graph)
        return self.launch_err

    def dia_error_string(self, err):
        return b"stand-in error"

    def dcg_graph_destroy(self, graph):
        self.destroyed.append(graph)

    def dcg_ws_destroy(self, handle):
        self.destroyed.append(handle)


CPU = torch.device("cpu")
SMALL_OFFSETS = (-34, -33, -1, 0, 1, 33, 34)


@pytest.mark.parametrize("dtype", [f32, f64])
def test_workspace_layout_and_padded_pitch_round_trip(dtype):
    """Every buffer the kernels read with 16-byte loads starts on 16
    bytes, the matrix rows have a pitch that is a multiple of 16 bytes,
    and load() round-trips the matrix exactly, padding left zero."""
    n, lib = 33 * 33, FakeDiaLib()       # odd n: rows of data unaligned
    ws = dia_cg._Workspace(lib, n, SMALL_OFFSETS, dtype, CPU)
    item = ws.buf.element_size()
    assert ws.pitch >= n and ws.pitch * item % 16 == 0
    vectors = (*ws.xs, ws.r, ws.p0, ws.p1, ws.Ap)
    assert len(vectors) == 7
    for v in vectors:
        assert v.shape == (n,) and v.data_ptr() % 16 == 0
    assert all(ws.data_padded[d].data_ptr() % 16 == 0 for d in range(7))
    assert ws.part.shape == (-(-n // 256),) and ws.sc.shape == (32,)
    assert lib.pointers == (ws.data_padded.data_ptr(), ws.xs.data_ptr(),
                            ws.part.data_ptr(), ws.sc.data_ptr())
    pitch, npad, runs, stages, nc, cl, start, length = lib.geometry
    assert pitch == ws.pitch and npad * item % 16 == 0 and npad >= n
    assert ws.r.data_ptr() - ws.xs[2].data_ptr() == npad * item
    # at this width the whole stencil is one cluster (gaps of 32)
    assert (runs, stages, nc, cl, start, length) == (
        4, 2, 1, [0] * 7, [-36], [1024 + 72])
    assert ws.k1_shape() == (132, dia_cg.k1_smem_bytes(7, ws.plan, item))
    data = torch.as_tensor(np.random.default_rng(0).normal(size=(7, n)),
                           dtype=dtype)
    ws.load(data)
    assert torch.equal(ws.data, data)
    assert torch.equal(ws.data_padded[:, :n], data)
    assert float(ws.data_padded[:, n:].abs().max()) == 0.0
    ws.load(2.0 * data)                         # a second matrix, same rows
    assert torch.equal(ws.data, 2.0 * data)
    # the buffers do not overlap: writing each leaves the others alone
    for k, v in enumerate((*vectors, ws.part, ws.sc)):
        v.fill_(k + 1.0)
    assert [float(v.min()) for v in (*vectors, ws.part, ws.sc)] == [
        1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0]
    assert torch.equal(ws.data, 2.0 * data)


def test_workspace_captures_each_chunk_graph_once():
    lib = FakeDiaLib()
    ws = dia_cg._Workspace(lib, 800, SMALL_OFFSETS, f32, CPU)
    for chunk, first in ((64, True), (64, False), (64, False), (5, True),
                         (64, True), (5, False)):
        ws.launch(chunk, first, 0)
    assert lib.captures == [(64, 1), (64, 0), (5, 1), (5, 0)]
    assert lib.launches == [2001, 2002, 2002, 2003, 2001, 2004]
    assert dia_cg._graph_key(64, 1) == dia_cg._graph_key(64.0, True)
    ws.set_params(1e-6, 500, 128, 1e4)
    assert ws.sc[16:20].tolist() == [float(np.float32(1e-6)), 500.0, 128.0,
                                     1e4]
    ws.set_state(LIVE=1.0, BETA=0.375)
    assert ws.sc[6] == 1.0 and ws.sc[9] == 0.375 and ws.sc[16] == 0.0
    ws.close()
    assert sorted(lib.destroyed) == [55, 2001, 2002, 2003, 2004]


@pytest.mark.parametrize("fault, message", [
    (dict(create_err=1), "dcg_ws_create: CUDA error 1"),
    (dict(capture_err=2), "dcg_capture: CUDA error 2"),
    (dict(launch_err=700), "dcg_launch: CUDA error 700"),
    # the kernel lays a stage out otherwise than the plan counted
    (dict(smem_off=16), "K1 takes 78992 B of shared memory where its plan "
                        "counted 78976 B"),
])
def test_workspace_failures_raise(fault, message):
    with pytest.raises(RuntimeError, match=message):
        ws = dia_cg._Workspace(FakeDiaLib(**fault), 800, SMALL_OFFSETS, f32,
                               CPU)
        ws.launch(64, True, 0)


def test_solve_replays_one_graph_per_chunk_and_reuses_the_workspace(
        monkeypatch):
    """_kernel_solve against a stand-in device that ends the solve in its
    third chunk: one launch and one read per chunk, the first chunk's
    graph primes, and a second solve (another matrix) and a solve of
    another shape capture nothing they do not need."""
    lib = FakeDiaLib()
    monkeypatch.setattr(dia_cg, "lib", lambda: lib)
    monkeypatch.setattr(dia_cg, "_workspaces", {})
    monkeypatch.setattr(dia_cg, "stream_of", lambda t: 0)
    offsets, data, b = _cg_system()
    n = b.shape[0]

    def device(graph):
        ws = dia_cg._workspaces[(CPU, n, tuple(offsets), f32)]
        assert torch.equal(ws.r, b) and torch.equal(ws.data, device.matrix)
        assert ws.sc[16:20].tolist() == [float(np.float32(1e-6)), 500.0,
                                         128.0, 1e4]
        done = len(lib.launches) % 3 == 0
        ws.sc[0], ws.sc[6] = 64.0 * len(lib.launches), 0.0 if done else 1.0
        ws.sc[11] = 2.0                     # the best iterate: buffer 2
        ws.xs[2].fill_(float(len(lib.launches)))

    lib.on_launch = device
    launches, replays = dia_cg.solve.launches, dia_cg.solve.replays
    device.matrix = data
    x, its = dia_cg._kernel_solve(tuple(offsets), data, b, 1e-6, 500,
                                  dia_cg.STALL_GUARD, dia_cg.STALL_WINDOW,
                                  64)
    assert its == 192 and float(x.min()) == 3.0
    assert lib.captures == [(64, 1), (64, 0)]
    assert lib.launches == [2001, 2002, 2002]
    assert dia_cg.solve.launches == launches + 192
    assert dia_cg.solve.replays == replays + 3
    device.matrix = 3.0 * data
    x2, _ = dia_cg._kernel_solve(tuple(offsets), 3.0 * data, b, 1e-6, 500,
                                 dia_cg.STALL_GUARD, dia_cg.STALL_WINDOW, 64)
    assert lib.captures == [(64, 1), (64, 0)] and len(lib.created) == 1
    assert float(x.min()) == 3.0 and float(x2.min()) == 6.0   # x is a copy
    # one workspace per (n, offsets, dtype)
    lib.on_launch = None
    ws = dia_cg._workspace(tuple(offsets), b)
    assert dia_cg._workspace(tuple(offsets), b) is ws
    assert dia_cg._workspace(tuple(offsets), b.double()) is not ws
    assert dia_cg._workspace(tuple(offsets), b[:-1]) is not ws
    assert dia_cg._workspace(tuple(offsets[1:]), b) is not ws
    assert lib.created == [(0, n, 7), (1, n, 7), (0, n - 1, 7), (0, n, 6)]
    dia_cg.release_workspaces()
    assert dia_cg._workspaces == {} and lib.destroyed.count(55) == 4
    assert sorted(set(lib.destroyed)) == [55, 2001, 2002]
