"""CPU tests of the per-layer metrics that read the program's own spans
and counters (pgbench/spans.py and its readers): on synthetic
recordings, on a program without the recorder, and in a tiny traced run
of each cell, where each reports in exactly the cells BENCHMARK.json
lists for it.

    python -m pytest pgbench/tests -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pgbench import harness, spans  # noqa: E402
from pgbench.run import run_cell  # noqa: E402
from proximalgalerkin_torch.core import logging as pglog  # noqa: E402

READERS = ["krylov_share", "newton_self_share.p1", "host_reads.p1",
           "element_matrix_share", "newton_self_share.lvpp",
           "host_reads.lvpp", "bt_apply_share", "bt_refine_passes"]
MS = 1_000_000


def reader(name):
    cell = harness.load_cell(ROOT, "obstacle_p1_1024.mg")
    return cell.reader(name)


def recording(spec, solve=1, first=0):
    """Spans from (name, parent position or -1, start ms, end ms,
    counts) tuples, as the recorder keeps them."""
    out = []
    for i, (name, parent, a, b, counts) in enumerate(spec):
        s = pglog.Span(name, -1 if parent < 0 else first + parent, solve)
        s.index, s.start_ns, s.end_ns = first + i, a * MS, b * MS
        s.counts = dict(counts)
        out.append(s)
    return out


P1 = [("p1.solve", -1, 0, 1000, {"host_reads": 2}),
      ("p1.newton_step", 0, 100, 500, {"host_reads": 4}),
      ("p1.inner_solve", 1, 150, 450, {"host_reads": 5}),
      ("p1.newton_step", 0, 500, 900, {"host_reads": 3}),
      ("p1.inner_solve", 3, 520, 820, {"host_reads": 6}),
      ("p1.inner_solve", 3, 830, 880, {"host_reads": 1})]
LVPP = [("lvpp.solve", -1, 0, 2000, {"host_reads": 1}),
        ("lvpp.step", 0, 10, 1990, {"host_reads": 2}),
        ("newton.solve", 1, 20, 1900, {"host_reads": 3}),
        ("linear_solve_bt", 2, 100, 1500, {}),
        ("bt_assemble", 3, 110, 600, {}),
        ("element_matrices", 4, 120, 500, {}),
        ("bt_solve", 3, 700, 1400, {"host_reads": 2}),
        ("bt.apply", 6, 710, 900, {}),
        ("bt.residual", 6, 900, 950, {}),
        ("bt.apply", 6, 960, 1200, {"bt.refine_passes": 1}),
        ("bt.residual", 6, 1200, 1250, {}),
        ("residual", 2, 1500, 1600, {})]


@pytest.fixture
def recorded(monkeypatch):
    """Install a synthetic recording: the first traced solve given,
    a second one after it that the readers must not take."""
    def install(spec):
        first = recording(spec)
        again = recording([(n, p, a + 5000, b + 5000, {"host_reads": 99})
                           for n, p, a, b, _ in spec], solve=2,
                          first=len(first))
        other = recording([("elsewhere", -1, 0, 1, {"host_reads": 7})],
                          solve=0, first=100)
        monkeypatch.setattr(pglog, "recorded",
                            lambda: [other, first, again])
        return first
    return install


def test_p1_readers_on_a_synthetic_solve(recorded):
    recorded(P1)
    record = {"solve_s": 2.0}
    # inner solves 300 + 300 + 50 ms of a 2 s traced solve
    assert reader("krylov_share").read(record) == pytest.approx(32.5)
    # self time: root 1000 - 400 - 400, steps 400 - 300 and 400 - 350
    assert reader("newton_self_share.p1").read(record) == pytest.approx(
        100.0 * (0.2 + 0.1 + 0.05) / 2.0)
    assert reader("host_reads.p1").read(record) == 21.0
    for name in ("element_matrix_share", "newton_self_share.lvpp",
                 "host_reads.lvpp", "bt_apply_share", "bt_refine_passes"):
        assert reader(name).read(record) is None, name


def test_lvpp_readers_on_a_synthetic_solve(recorded):
    recorded(LVPP)
    record = {"solve_s": 4.0}
    assert reader("element_matrix_share").read(record) == pytest.approx(
        100.0 * 0.38 / 4.0)
    # self: root 2000 - 1980, step 1980 - 1880, newton 1880 - 1400 - 100
    assert reader("newton_self_share.lvpp").read(record) == pytest.approx(
        100.0 * (0.02 + 0.1 + 0.38) / 4.0)
    assert reader("host_reads.lvpp").read(record) == 8.0
    assert reader("bt_apply_share").read(record) == pytest.approx(
        100.0 * 0.43 / 4.0)
    assert reader("bt_refine_passes").read(record) == 1.0
    for name in ("krylov_share", "newton_self_share.p1", "host_reads.p1"):
        assert reader(name).read(record) is None, name


def test_lu_solve_has_no_refinement_passes(recorded):
    recorded([s for s in LVPP if not s[0].startswith("bt")])
    assert reader("bt_refine_passes").read({"solve_s": 4.0}) is None
    assert reader("bt_apply_share").read({"solve_s": 4.0}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_recorder_gives_none(name, monkeypatch):
    monkeypatch.delattr(pglog, "recorded")
    assert reader(name).read({"solve_s": 1.0}) is None


def test_self_time_subtracts_direct_children_only():
    group = recording([("a", -1, 0, 10, {}), ("b", 0, 1, 9, {}),
                       ("c", 1, 2, 8, {})])
    assert spans.self_seconds(group, ["a"]) == pytest.approx(0.002)
    assert spans.self_seconds(group, ["a", "b"]) == pytest.approx(0.004)
    assert spans.seconds(group, ["c"]) == pytest.approx(0.006)


@pytest.mark.parametrize("name", ["obstacle_p1_1024.mg",
                                  "obstacle_p1_1024.jacobi",
                                  "obstacle_disk.btlu", "obstacle_disk.lu"])
def test_traced_run_reports_the_new_metrics_in_their_cells(name):
    pglog.RECORDER.clear()
    cell = harness.load_cell(ROOT, name)
    cell.config.update({"obstacle_p1_1024": {"n": 16},
                        "obstacle_disk": {"res": 0.2}}[cell.config["name"]])
    out = run_cell(cell, 987654321098, 0.01, True, torch.device("cpu"), 0.0)
    line = json.loads(out["line"])
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in spec["per_layer"]
              if m["name"] in READERS and name in m["workloads"]}
    assert listed and set(line["metrics"]) & set(READERS) == listed
    for m in listed:
        v = line["metrics"][m]["value"]
        if line["metrics"][m]["unit"] == "%":
            assert 0.0 < v < 100.0, (m, v)
        else:
            assert v >= 0 and v == int(v), (m, v)
