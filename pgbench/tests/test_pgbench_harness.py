"""CPU tests of the benchmark harness at tiny sizes: the result line,
the reference against the port's CPU path, faults planted under the
timed path, files found by name, the frozen yardstick, and the imports.

    python -m pytest pgbench/tests -q
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pgbench import harness, inputs, meshes, roofline  # noqa: E402
from pgbench.run import run_cell  # noqa: E402

CPU = torch.device("cpu")
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]
TINY = {"obstacle_p1_1024": {"n": 16}, "obstacle_disk": {"res": 0.2}}
CELLS = ["obstacle_p1_1024.mg", "obstacle_p1_1024.jacobi",
         "obstacle_disk.btlu", "obstacle_disk.lu"]


def tiny_cell(name: str, root: Path = ROOT, **sizes) -> harness.Cell:
    cell = harness.load_cell(root, name)
    cell.config.update(TINY[cell.config["name"]], **sizes)
    return cell


def run(cell, trace=False, driver=None, seed=123456789012):
    return run_cell(cell, seed, 0.01, trace, CPU, 0.0, driver=driver)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_last_line_has_the_contract_keys(name, trace):
    cell = tiny_cell(name)
    out = run(cell, trace)
    line = json.loads(out["line"])
    keys = CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    wanted = {m["name"] for m in cell.metrics(trace)}
    assert set(line["metrics"]) <= wanted
    if not trace:
        assert set(line["metrics"]) == wanted
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


class Broken:
    """The cell's driver with its solve broken underneath."""

    def __init__(self, driver, fault: str):
        self.d, self.fault = driver, fault

    def setup(self, *a, **k):
        return self.d.setup(*a, **k)

    def warmup(self, state):
        return self.d.warmup(state)

    def solve(self, state):
        ans = self.d.solve(state)
        f = {k: v.copy() for k, v in ans.fields.items()}
        if self.fault == "unchanged":
            # a solve that returns its initial state: u = 0 and the
            # latent field where the solver starts it
            f["u"][:] = 0.0
            f["psi"][:] = 1.0 if "cg" in ans.extra else 0.0
        else:
            # one answer altered where it is produced
            i = int(np.argmax(np.abs(f["u"])))
            f["u"][i] += 1e-3 * np.abs(f["u"]).max()
        return harness.Answer(ans.counts, ans.converged, f, ans.extra)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("name", ["obstacle_p1_1024.mg",
                                  "obstacle_disk.btlu"])
def test_a_broken_solve_is_not_correct(name, fault):
    cell = tiny_cell(name, **({"n": 8} if "p1" in name else {}))
    out = run(cell, driver=Broken(cell.driver(), fault))
    line = json.loads(out["line"])
    assert line["correct"] is False
    assert line["failed"] == line["attempted"]


@pytest.mark.parametrize("name", ["obstacle_p1_1024.jacobi",
                                  "obstacle_disk.lu"])
def test_reference_agrees_with_the_port_and_catches_a_perturbation(name):
    cell = tiny_cell(name)
    inp = inputs.make(cell.config, cell.workload["params"], 7)
    driver, ref = cell.driver(), cell.reference()
    ans = driver.solve(driver.setup(cell.config, cell.workload, inp, CPU))
    ctx = ref.prepare(inp, cell.config)
    good = ref.numbers(ctx, ans.fields)
    assert all(v <= ref.LIMITS[k] for k, v in good.items()), good
    u = ans.fields["u"].copy()
    u[int(np.argmax(u))] *= 1.0 + 1e-4
    bad = ref.numbers(ctx, dict(ans.fields, u=u))
    assert any(v > ref.LIMITS[k] for k, v in bad.items()), bad


@pytest.mark.parametrize("name", ["obstacle_p1_1024.mg",
                                  "obstacle_disk.btlu"])
def test_the_controls_are_not_correct(name):
    from pgbench.control import readings
    # at res 0.1 float32 cannot carry the disk's LVPP past its second
    # step; at res 0.2 it runs on, within 3e-7 of the reference
    p1 = "p1" in name
    cell = tiny_cell(name, **({"n": 8} if p1 else {"res": 0.1}))
    kinds = ("program", "program_f32",
             "rounded_f32" if p1 else "reference_f32")
    got = {kind: ok for kind, _, _, ok in readings(cell, 3, CPU, kinds)}
    assert got.pop("program") is True
    assert got and not any(got.values()), got


def test_files_are_found_by_name(tmp_path):
    """A throwaway configuration, cell and metric added as files and
    BENCHMARK.json entries, with no file of the harness edited."""
    shutil.copytree(ROOT / "pgbench", tmp_path / "pgbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "pgbench"
    cfg = json.loads((b / "configs" / "obstacle_p1_1024.json").read_text())
    cfg.update(name="tiny_rect", n=8)
    (b / "configs" / "tiny_rect.json").write_text(json.dumps(cfg))
    shutil.copy(b / "reference" / "obstacle_p1_1024.py",
                b / "reference" / "tiny_rect.py")
    (b / "workloads" / "tiny_rect.wide.json").write_text(json.dumps({
        "config": "tiny_rect", "traffic": "wide",
        "params": {"centre_radius": 0.05, "solver": {"pc": "jacobi"}},
        "why": "throwaway"}))
    (b / "metrics" / "outer_steps.tiny.py").write_text(
        "def read(record):\n    return float(record['counts']['outer'])\n")
    spec["configs"].append({"name": "tiny_rect", "source": "test",
                            "file": "pgbench/configs/tiny_rect.json",
                            "reduced": ["n"], "why": "throwaway"})
    spec["workloads"].append({"name": "tiny_rect.wide", "config":
                              "tiny_rect", "traffic": "wide", "chips": 1,
                              "why": "throwaway"})
    spec["end_to_end"][1]["workloads"].append("tiny_rect.wide")
    spec["per_layer"].append({
        "name": "outer_steps.tiny", "unit": "steps", "better": "lower",
        "source": "program_counter", "layer": "P1 outer loop",
        "moves": "solve_s.p1", "workloads": ["tiny_rect.wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(tmp_path, "tiny_rect.wide")
    line = json.loads(run(cell, trace=True)["line"])
    assert line["correct"] is True
    assert line["metrics"]["outer_steps.tiny"]["value"] >= 1
    line = json.loads(run(cell)["line"])
    assert set(line["metrics"]) == {"setup_s", "solve_s.p1"}


def test_meshes_are_the_ports():
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    p, c = meshes.rectangle(16, 16, (-1.0, -1.0), (1.0, 1.0))
    m = rectangle_mesh(16, 16, p0=(-1.0, -1.0), p1=(1.0, 1.0))
    assert np.array_equal(p, m.points) and np.array_equal(c, m.cells)
    for res in (0.2, 0.1):
        p, c = meshes.disk(res)
        m = create_disk_mesh(res=res)
        assert np.array_equal(p, m.points) and np.array_equal(c, m.cells)


def test_cap_is_the_ports_at_the_origin():
    from proximalgalerkin_torch.models.obstacle import spherical_cap_obstacle
    from pgbench.reference._p1 import cap
    x = np.random.default_rng(0).uniform(-1, 1, (2, 500))
    assert np.array_equal(inputs.spherical_cap(x), spherical_cap_obstacle(x))
    np.testing.assert_allclose(cap(x, (0.0, 0.0)), spherical_cap_obstacle(x),
                               rtol=1e-15, atol=1e-15)


def test_seeds_give_the_same_inputs():
    a = inputs.centre_of(2**31 + 12345, 5e-4)
    assert a == inputs.centre_of(2**31 + 12345, 5e-4)
    assert a != inputs.centre_of(2**31 + 12346, 5e-4)
    assert np.hypot(*a) <= 5e-4


def test_yardstick_matches_chip_smoke():
    import chip_smoke
    m = 1025
    assert roofline.mg_iteration_bytes(m) == chip_smoke.mg_iteration_bytes(m)
    assert roofline.fd_iteration_bytes(m) == chip_smoke.fd_iteration_bytes(m)
    assert roofline.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    ms = 1e3 * roofline.least_seconds(roofline.mg_iteration_bytes(m))
    assert round(ms, 4) == 0.0130
    assert round(1e3 * roofline.least_seconds(
        roofline.K1_ROW_BYTES * m * m), 4) == 0.0138
    assert round(1e3 * roofline.least_seconds(
        roofline.K2_ROW_BYTES * m * m), 4) == 0.0075
    assert roofline.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4


def test_trace_summary_reads_busy_and_gaps():
    class E:
        def __init__(self, name, dev, kind, a, b):
            self._n, self._d, self._k, self._a, self._b = name, dev, kind, a, b

        def name(self):
            return self._n

        def device_type(self):
            return self._d

        def activity_type(self):
            return self._k

        def start_ns(self):
            return self._a

        def end_ns(self):
            return self._b

    ev = [E("k_a", "DeviceType.CUDA", "kernel", 100, 300),
          E("k_b", "DeviceType.CUDA", "kernel", 250, 400),
          E("k_a", "DeviceType.CUDA", "kernel", 800, 900),
          E("aten::item", "DeviceType.CPU", "cpu_op", 400, 800)]
    s = harness.summarize_trace(ev, (0, 1000))
    assert s["busy_s"] == pytest.approx(400e-9)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["kernels"]["k_a"] == [pytest.approx(300e-9), 2]
    assert s["idle_gaps"][0] == ("aten::item", pytest.approx(400e-9))


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "pgbench" / "reference").glob("*.py"):
        assert not _imports(f) & {"proximalgalerkin_torch",
                                  *harness.FORBIDDEN}, f
    code = ("import sys; sys.path.insert(0, %r); "
            "import pgbench.reference.obstacle_disk, "
            "pgbench.reference.obstacle_p1_1024; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'proximalgalerkin_torch', 'jax', 'jaxlib', 'flax', "
            "'proximalgalerkin_tpu'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.stdout.strip() == "[]", out.stderr


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from pgbench import harness\n"
            "from pgbench.run import run_cell\n"
            "cell = harness.load_cell(harness.Path(%r), "
            "'obstacle_disk.btlu')\n"
            "cell.config['res'] = 0.3\n"
            "run_cell(cell, 5, 0.01, True, torch.device('cpu'), 0.0)\n"
            "print(harness.forbidden_loaded())\n" % (str(ROOT), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "pgbench/run.py", "--workload",
         "obstacle_p1_1024.mg", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "pgbench/run.py", "--workload",
         "obstacle_p1_1024.mg", "--seed", "4242", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
