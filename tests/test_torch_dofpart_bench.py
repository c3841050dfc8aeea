"""The benchmark's distributed cell (`obstacle_dist_224.asm_btlu`, its
driver `pgbench/drivers/lvpp_distributed.py` and plain reference
`pgbench/reference/obstacle_dist_224.py`) on the CPU at 16^2, 8
subdomains: the program's first LVPP step within the cell's limits of
the reference and with the single-device host-LU run's counts, an
altered answer refused, and the cell's files and metric lists found by
name and consistent."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pgbench import harness, inputs

ROOT = Path(__file__).resolve().parents[1]
CELL = "obstacle_dist_224.asm_btlu"
SEED = 2**31 + 4321
# the new per-layer metrics, and the accepted ones the cell reports
NEW = ["asm_factor_share", "asm_apply_share", "dist_action_share",
       "gmres_its.dist"]
SHARED = ["newton_steps.lvpp", "idle_share.lvpp", "host_reads.lvpp",
          "newton_self_share.lvpp", "element_matrix_share"]
LAYER = "distributed layer (parallel/dofpart)"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell(n: int = 16) -> harness.Cell:
    cell = harness.load_cell(ROOT, CELL)
    cell.config["n"] = n
    return cell


@pytest.fixture(scope="module")
def solved():
    """The cell at 16^2 on the CPU: (cell, inputs, the program's answer,
    the reference's solution)."""
    cell = small_cell()
    inp = inputs.make(cell.config, cell.workload["params"], SEED)
    driver = cell.driver()
    state = driver.setup(cell.config, cell.workload, inp,
                         torch.device("cpu"))
    ans = driver.solve(state)
    return cell, inp, ans, cell.reference().prepare(inp, cell.config)


def test_program_meets_the_reference_and_host_lu_counts(solved):
    from proximalgalerkin_torch.mesh.mesh import Mesh
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    cell, inp, ans, ref = solved
    lv = cell.config["lvpp"]
    assert ans.converged
    assert ans.extra["owned"] * 8 >= len(inp.points) * 2
    assert sum(ans.extra["gmres_its"]) > 0
    nums = cell.reference().numbers(ref, ans.fields)
    limits = cell.reference().LIMITS
    assert set(nums) == set(limits)
    assert all(v <= limits[k] for k, v in nums.items()), nums
    # the single-device host-LU run of the same step: the same counts
    host = setup_obstacle_problem(
        Mesh("triangle", inp.points, inp.cells), polynomial_order=1,
        alpha_scheme=lv["alpha_scheme"], alpha_max=lv["alpha_max"],
        maximum_number_of_outer_loop_iterations=lv["max_outer"],
        tol_exit=lv["tol_exit"], obstacle=inp.obstacle,
        quadrature_degree=lv["quadrature_degree"],
        solver_options=dict(cell.config["newton"]), verbose=False,
        device="cpu").solve()
    assert ans.counts == {"outer": host.iterations,
                          "newton": list(host.newton_steps)}
    assert ans.counts == {"outer": 1, "newton": ref["newton"]}


def test_an_altered_answer_is_refused(solved):
    cell, _, ans, ref = solved
    reference = cell.reference()
    u = ans.fields["u"].copy()
    i = int(np.argmax(np.abs(u)))
    u[i] += 1e-8 * np.abs(u).max()
    nums = reference.numbers(ref, dict(ans.fields, u=u))
    assert nums["u_gap"] > reference.LIMITS["u_gap"], nums
    # the answer rounded to float32, the cell's control
    r32 = {k: v.astype(np.float32).astype(np.float64)
           for k, v in ans.fields.items()}
    nums = reference.numbers(ref, r32)
    assert any(v > reference.LIMITS[k] for k, v in nums.items()), nums


def test_the_cell_is_found_by_name_with_consistent_metrics():
    cell = harness.load_cell(ROOT, CELL)
    spec = cell.spec
    assert cell.config["name"] == cell.entry["config"] == "obstacle_dist_224"
    assert cell.entry["chips"] == 1 and cell.config["subdomains"] == 8
    (conf,) = [c for c in spec["configs"] if c["name"] == "obstacle_dist_224"]
    assert conf["reduced"] == ["max_outer"] == cell.config["reduced"]
    assert cell.config["published"]["max_outer"] == 4
    assert cell.driver().__name__ == "pgbench_driver_lvpp_distributed"
    assert set(cell.reference().LIMITS) == {"u_gap", "latent_gap"}
    e2e = {m["name"] for m in cell.metrics(False)}
    assert e2e == {"setup_s", "solve_s.lvpp"}
    per_layer = {m["name"]: m for m in cell.metrics(True)}
    assert set(per_layer) == set(NEW + SHARED)
    for name, m in per_layer.items():
        assert m["moves"] in e2e, name
        assert hasattr(cell.reader(name), "read"), name
    for name in NEW:
        m = per_layer[name]
        assert m["layer"] == LAYER and m["workloads"] == [CELL], name
    # the new metrics give one layer name, letter for letter
    assert {m["layer"] for m in spec["per_layer"]
            if m["name"] in NEW} == {LAYER}
    # every cell a metric lists exists and reports what it moves
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"] + spec["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_and_driver_import_no_jax():
    bench = ROOT / "pgbench"
    ref = bench / "reference" / "obstacle_dist_224.py"
    assert not _imports(ref) & {"proximalgalerkin_torch",
                                *harness.FORBIDDEN}
    drv = bench / "drivers" / "lvpp_distributed.py"
    assert not _imports(drv) & set(harness.FORBIDDEN)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from pgbench import harness\n"
            "cell = harness.load_cell(harness.Path(%r), %r)\n"
            "cell.reference()\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'proximalgalerkin_torch', *harness.FORBIDDEN}))\n"
            "cell.driver()\n"
            "import proximalgalerkin_torch.parallel.dofpart\n"
            "print(harness.forbidden_loaded())\n"
            % (str(ROOT), str(ROOT), CELL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines() == ["[]", "[]"]


def test_the_configuration_is_the_records():
    """The configuration's published layout is the record's."""
    rec = json.loads((ROOT / "records" /
                      "rec_distributed_obstacle_224.json").read_text())
    pub = harness.load_cell(ROOT, CELL).config["published"]
    assert pub["dofs"] == rec["dofs"]
    assert pub["per_subdomain_owned"] == rec["per_device_owned"]
    assert pub["ext_total"] == rec["ext_total"]
    assert pub["nb_bs"] == rec["subdomain_nb_bs"]
    assert pub["newton"] == rec["dist_newton"] == rec["ref_newton"]
