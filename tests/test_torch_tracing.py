"""The port's span and counter recorder (core/logging) on the CPU: off,
a span costs a flag test and synchronises nothing; under torch.profiler
spans nest, share their root's solve id and sit on the profiler's clock;
counters reach the open span only while tracing is on; a CUDA graph
capture records nothing; the fast path, the general stack and the
distributed layer record the spans and host reads that the benchmark's
per-layer metrics read."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from proximalgalerkin_torch.core import logging as pglog
from proximalgalerkin_torch.core.logging import (PhaseTimer, count, counter,
                                                 recorded, span, tracing)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def syncs(monkeypatch):
    """Every synchronise a span could call, counted: the card's (CUDA
    taken as up) and PhaseTimer's."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("cuda"))
    monkeypatch.setattr(PhaseTimer, "_sync",
                        lambda self: calls.append("timer"))
    return calls


def _root(name):
    """The last recorded group whose root is `name`."""
    groups = [g for g in recorded() if g[0].name == name]
    assert groups, f"no solve rooted at {name!r} recorded"
    return groups[-1]


def _event_span(e):
    a = e.start_ns()
    return a, (e.end_ns() if hasattr(e, "end_ns") else a + e.duration_ns())


def test_off_a_span_records_and_synchronises_nothing(syncs, monkeypatch):
    assert not pglog.RECORDER.on()

    def no_clock():
        raise AssertionError("a span read the clock with tracing off")

    kept = len(pglog.RECORDER.spans)
    timer = PhaseTimer("cuda")
    with monkeypatch.context() as m:
        m.setattr(pglog.time, "perf_counter_ns", no_clock)
        m.setattr(pglog.time, "time_ns", no_clock)
        for _ in range(3):
            with span("off"):
                with span("off.inner"):
                    pass
    with timer.phase("phase_off"):
        pass
    assert syncs == []
    assert len(pglog.RECORDER.spans) == kept
    assert pglog.RECORDER.open == []
    # the timer keeps its host-clock totals either way
    assert timer.counts == {"phase_off": 1}


def test_spans_nest_under_the_profiler_on_its_clock():
    kept = len(pglog.RECORDER.spans)
    a = torch.ones(128, 128, dtype=torch.float64)
    timer = PhaseTimer("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert pglog.RECORDER.on()
        with span("t.outer"):
            (a @ a).sum()
            with span("t.inner"):
                (a @ a).sum()
                with timer.phase("t.phase"):
                    (a @ a).sum()
            with span("t.inner"):
                (a @ a).sum()
    group = _root("t.outer")
    assert len(pglog.RECORDER.spans) == kept + 4
    root, in1, ph, in2 = group
    assert [s.name for s in group] == ["t.outer", "t.inner", "t.phase",
                                       "t.inner"]
    assert root.parent == -1
    assert in1.parent == in2.parent == root.index and ph.parent == in1.index
    assert len({s.solve for s in group}) == 1
    assert timer.counts == {"t.phase": 1}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("pg.t.")]
    assert sorted(e.name() for e in events) == sorted(
        "pg." + s.name for s in group)
    slack = 500_000                                   # 0.5 ms
    for e in events:
        a0, b0 = _event_span(e)
        mine = [s for s in group if "pg." + s.name == e.name()
                and s.start_ns <= a0 + slack and s.end_ns >= b0 - slack]
        assert mine, (e.name(), a0, b0,
                      [(s.start_ns, s.end_ns) for s in group])
    for s in group:
        assert s.end_ns >= s.start_ns
    assert root.start_ns <= in1.start_ns <= in1.end_ns <= in2.start_ns \
        <= in2.end_ns <= root.end_ns


def test_counters_reach_the_open_span_only_while_tracing():
    before = counter("t.events")
    count("t.events")
    count("t.events", 4)
    assert counter("t.events") == before + 5
    with span("t.untraced"):                    # tracing off: no span
        count("t.events")
    assert counter("t.events") == before + 6
    with tracing():
        with span("t.counting"):
            count("t.events", 2)
            with span("t.counting.inner"):
                count("t.events")
            count("t.other")
    count("t.events")
    assert counter("t.events") == before + 10
    root, inner = _root("t.counting")
    assert root.counts == {"t.events": 2, "t.other": 1}
    assert inner.counts == {"t.events": 1}


def test_a_graph_capture_records_and_synchronises_nothing(syncs,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    kept = len(pglog.RECORDER.spans)
    timer = PhaseTimer("cuda")
    with tracing():
        with span("t.captured"):
            count("t.captured")
            with timer.phase("t.captured_phase"):
                pass
    assert syncs == []
    assert len(pglog.RECORDER.spans) == kept and pglog.RECORDER.open == []
    assert timer.counts == {"t.captured_phase": 1}
    # the same spans outside a capture synchronise at both edges
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with tracing():
        with span("t.not_captured"):
            with timer.phase("t.phase"):
                pass
    assert syncs == ["cuda", "timer", "timer", "cuda"]
    assert [s.name for s in _root("t.not_captured")] == ["t.not_captured",
                                                         "t.phase"]


def test_spans_beyond_the_bound_are_counted_not_kept():
    rec = pglog.Recorder()
    rec.max_spans, rec.forced = 2, 1
    with rec.span("a"):
        with rec.span("b"):
            rec.count("n")
            with rec.span("c"):
                rec.count("n")
    assert [s.name for s in rec.spans] == ["a", "b"] and rec.dropped == 1
    assert rec.spans[1].counts == {"n": 1} and rec.totals == {"n": 2}
    assert rec.recorded() == [rec.spans]


@pytest.mark.parametrize("pc", ["mg", "jacobi"])
def test_fast_path_spans_and_host_reads(pc, monkeypatch):
    """A 32^2 mixed-precision solve traced twice: the same spans and host
    reads both times, every read inside the root, and the count that
    PERF.md gives: 2 (u and psi) + per outer step 2 (the first residual
    norm, the increment) + per Newton step 3 (its residual norm, two
    refinement decisions) + one per 64-iteration chunk of each inner
    solve (at least one)."""
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models import obstacle_p1
    from proximalgalerkin_torch.ops import dia_cg, mgfused
    mesh = rectangle_mesh(32, 32, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    solver = obstacle_p1.P1ObstacleSolver(
        mesh, device="cpu", alpha_cap=1e2, outer_tol=1e-8,
        mixed_precision=True, pc=pc)
    module = mgfused if pc == "mg" else dia_cg
    inner_its = []
    real = module.solve

    def counted(*a, **k):
        x, its = real(*a, **k)
        inner_its.append(its)
        return x, its

    monkeypatch.setattr(module, "solve", counted)
    seen = []
    for _ in range(2):
        inner_its.clear()
        before = counter("host_reads")
        with tracing():
            r = solver.solve()
        total = counter("host_reads") - before
        group = _root("p1.solve")
        reads = sum(s.counts.get("host_reads", 0) for s in group)
        names = [s.name for s in group]
        assert reads == total
        assert names.count("p1.newton_step") == r.newton_its
        assert names.count("p1.inner_solve") == len(inner_its)
        assert len(names) == 1 + r.newton_its + len(inner_its)
        chunks = sum(max(1, math.ceil(its / 64)) for its in inner_its)
        assert reads == (2 + 2 * r.outer_iterations + 3 * r.newton_its
                         + chunks)
        # each inner solve's chunk reads are its own
        per_inner = [s.counts.get("host_reads", 0) for s in group
                     if s.name == "p1.inner_solve"]
        assert per_inner == [max(1, math.ceil(i / 64)) for i in inner_its]
        seen.append((reads, names, r.cg_its_total))
    assert seen[0] == seen[1]


@pytest.mark.parametrize("direction", ["btlu", "lu"])
def test_general_stack_records_element_matrices(direction):
    """A coarse CPU disk solve records `element_matrices` under the
    direction's assembly phase (btlu: bt_assemble, LU: assembly), inside
    newton.solve, lvpp.step and the root lvpp.solve; the btlu direction
    records its applies, residuals and refinement passes."""
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    opts = ({"ksp_type": "preonly", "pc_type": "btlu",
             "pc_factor_dtype": "f64", "pc_factor_lag": 1,
             "ksp_rtol": 1e-12} if direction == "btlu" else None)
    prob = setup_obstacle_problem(
        create_disk_mesh(res=0.3), polynomial_order=1, verbose=False,
        maximum_number_of_outer_loop_iterations=3, solver_options=opts,
        device="cpu")
    before = counter("host_reads")
    with tracing():
        r = prob.solve()
    group = _root("lvpp.solve")
    by_index = {s.index: s for s in group}

    def chain(s):
        out = []
        while s.parent >= 0:
            s = by_index[s.parent]
            out.append(s.name)
        return out

    steps = [s for s in group if s.name == "lvpp.step"]
    assert len(steps) == r.iterations
    assert sum(s.name == "newton.solve" for s in group) == r.iterations
    em = [s for s in group if s.name == "element_matrices"]
    assert len(em) == sum(r.newton_steps)
    phase = "bt_assemble" if direction == "btlu" else "assembly"
    for s in em:
        assert chain(s)[0] == phase
        assert chain(s)[-3:] == ["newton.solve", "lvpp.step", "lvpp.solve"]
    reads = sum(s.counts.get("host_reads", 0) for s in group)
    assert 0 < reads <= counter("host_reads") - before
    applies = [s for s in group if s.name == "bt.apply"]
    passes = sum(s.counts.get("bt.refine_passes", 0) for s in group)
    if direction == "btlu":
        # one apply a refinement (a bt_solve phase), one more a pass
        assert len(applies) >= sum(r.newton_steps)
        assert len(applies) == sum(s.name == "bt.residual" for s in group)
        assert passes == len(applies) - sum(s.name == "bt_solve"
                                            for s in group)
    else:
        assert applies == [] and passes == 0


def test_distributed_solve_records_its_layer():
    """The benchmark's distributed cell at 16^2 on the CPU (8 subdomains,
    asm_btlu under GMRES(120)), its first Newton step: traced, the
    Newton solve, the Schwarz factor (with its element matrices), the
    GMRES solve and its actions and applies nest under `lvpp.solve`;
    `dist.gmres_its` is the solver's GMRES count, and the GMRES reads
    the host once an Arnoldi step, once a restart cycle and once for its
    target; no graph is captured off the card. Untraced, no span is
    kept and the counters still count."""
    from pathlib import Path

    from pgbench import harness, inputs
    root = Path(__file__).resolve().parents[1]
    cell = harness.load_cell(root, "obstacle_dist_224.asm_btlu")
    cell.config["n"] = 16
    inp = inputs.make(cell.config, cell.workload["params"], 11)
    driver = cell.driver()
    state = driver.setup(cell.config, cell.workload, inp,
                         torch.device("cpu"))
    newton = state.solver.newton
    newton.options["snes_max_it"] = 1
    restart = int(newton.options["ksp_gmres_restart"])
    captures = counter("dist.graph_captures")
    with tracing():
        driver.solve(state)
    its = newton.krylov_its[-1]
    group = _root("lvpp.solve")
    by_index = {s.index: s for s in group}

    def chain(s):
        out = []
        while s.parent >= 0:
            s = by_index[s.parent]
            out.append(s.name)
        return out

    names = [s.name for s in group]
    for name in ("newton.solve", "dist.asm_factor", "dist.gmres"):
        assert names.count(name) == 1, (name, names)
    (factor,) = [s for s in group if s.name == "dist.asm_factor"]
    (gmres,) = [s for s in group if s.name == "dist.gmres"]
    assert chain(factor) == chain(gmres) == [
        "newton_fused_distributed", "newton.solve", "lvpp.step",
        "lvpp.solve"]
    em = [s for s in group if s.name == "element_matrices"]
    assert em and all(chain(s)[0] == "dist.asm_factor" for s in em)
    cycles = -(-its // restart)
    actions = [s for s in group if s.name == "dist.jac_action"]
    applies = [s for s in group if s.name == "dist.asm_apply"]
    # an action an Arnoldi step and one a cycle's residual; an apply an
    # Arnoldi step and one a cycle's update
    assert len(actions) == len(applies) == its + cycles
    assert all(s.parent == gmres.index for s in actions + applies)
    assert gmres.counts["dist.gmres_its"] == its
    assert sum(s.counts.get("dist.gmres_its", 0) for s in group) == its
    assert gmres.counts["host_reads"] == its + cycles + 1
    assert counter("dist.graph_captures") == captures
    # untraced: the same counts, nothing kept
    kept = len(pglog.RECORDER.spans)
    before = counter("dist.gmres_its")
    driver.solve(state)
    assert len(pglog.RECORDER.spans) == kept
    assert counter("dist.gmres_its") - before == newton.krylov_its[-1]


def test_distributed_actions_from_element_matrices_are_counted():
    """`dist.ebe_actions` on the benchmark's distributed cell at 16^2 on
    the CPU, its first Newton step: on the asm_btlu path every GMRES
    action comes from the factor's element matrices, one count in each
    `dist.jac_action` span and as many in the process total untraced; on
    the jacobi path (MINRES on the jvp action) none."""
    from pathlib import Path

    from pgbench import harness, inputs
    root = Path(__file__).resolve().parents[1]
    cell = harness.load_cell(root, "obstacle_dist_224.asm_btlu")
    cell.config["n"] = 16
    inp = inputs.make(cell.config, cell.workload["params"], 11)
    driver = cell.driver()
    state = driver.setup(cell.config, cell.workload, inp,
                         torch.device("cpu"))
    newton = state.solver.newton
    newton.options["snes_max_it"] = 1
    restart = int(newton.options["ksp_gmres_restart"])
    with tracing():
        driver.solve(state)
    group = _root("lvpp.solve")
    actions = [s for s in group if s.name == "dist.jac_action"]
    assert len(actions) == newton.krylov_its[-1] + -(
        -newton.krylov_its[-1] // restart)
    assert all(s.counts.get("dist.ebe_actions") == 1 for s in actions)
    assert sum(s.counts.get("dist.ebe_actions", 0)
               for s in group) == len(actions)
    before = counter("dist.ebe_actions")
    driver.solve(state)
    its = newton.krylov_its[-1]
    assert counter("dist.ebe_actions") - before == its + -(-its // restart)
    # jacobi: the jvp action, none counted
    newton.options["pc_type"] = "jacobi"
    newton.options["ksp_max_it"] = 20
    before = counter("dist.ebe_actions")
    with tracing():
        driver.solve(state)
    group = _root("lvpp.solve")
    assert [s for s in group if s.name == "newton.solve"]
    assert not [s for s in group if s.name == "dist.asm_factor"]
    assert counter("dist.ebe_actions") == before
