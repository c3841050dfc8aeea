"""The port's multi-process start-up (parallel/multihost.py) with two real
OS processes on gloo (CPU tensors), each holding two of four subdomains
of a ShardComm over the world group: a psum across them, and the
reference's 3-step disk-0.25 LVPP obstacle through
DistributedLvppProblem, whose Newton counts and ||x|| must equal the
port's one-process 4-subdomain run and the reference package's
single-process run."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

_COMMON = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, os.getcwd())
    import torch
    torch.set_num_threads(1)
    from proximalgalerkin_torch.parallel.comm import world_comm
    from proximalgalerkin_torch.parallel.multihost import (
        init_multihost, is_coordinator, shutdown)

    pid, n, devs = init_multihost(device="cpu")
    assert n == 2 and devs == [torch.device("cpu")], (n, devs)
    comm = world_comm(4, "cpu")
    assert (comm.nloc, comm.lo) == (2, 2 * pid)
""")

_PSUM = _COMMON + textwrap.dedent("""
    # global shards [0, 1, 2, 3]: this process holds 2*pid and 2*pid + 1
    x = torch.tensor([[2.0 * pid], [2.0 * pid + 1.0]], dtype=torch.float64)
    total = float(comm.psum(x)[0])
    assert total == 6.0, total
    # ring: shard i receives shard (i + 1) mod 4, across the process edge
    y = comm.ring(x, 1)[:, 0].tolist()
    assert y == [float((2 * pid + i + 1) % 4) for i in range(2)], y
    assert comm.gather_shards(x)[:, 0].tolist() == [0.0, 1.0, 2.0, 3.0]
    if is_coordinator():
        print("MULTIHOST_OK", total, flush=True)
    shutdown()
""")

_LVPP = _COMMON + textwrap.dedent("""
    import numpy as np
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    from test_torch_multihost import lvpp_run
    counts, xnorm = lvpp_run(comm)
    if is_coordinator():
        print("LVPP_MULTIHOST", json.dumps([counts, xnorm]), flush=True)
    shutdown()
""")

OPTS = {"snes_rtol": 1e-6, "snes_max_it": 50,
        "snes_linesearch_type": "none", "ksp_type": "minres",
        "pc_type": "jacobi", "mat_type": "matfree",
        "ksp_rtol": 1e-11, "ksp_max_it": 2000}


def lvpp_run(comm):
    """The 3-step disk-0.25 obstacle LVPP on the subdomains of `comm`:
    (Newton counts, ||x||). Every process builds the same problem (the
    mesher is deterministic) and keeps its own subdomains."""
    from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    from proximalgalerkin_torch.parallel.dofpart import (
        DistributedLvppProblem, DistributedProblem)
    from proximalgalerkin_torch.solve.lvpp import AlphaScheduler, LVPPSolver

    prob = setup_obstacle_problem(create_disk_mesh(0.25), polynomial_order=1,
                                  verbose=False, device=comm.device)
    p = prob.problem
    dp = DistributedProblem(p, comm)
    dlp = DistributedLvppProblem(dp)
    dlp.update(coeffs={"phi": dp.scatter_cellq(p.coeffs["phi"])})
    res = LVPPSolver(
        dlp, newton_options=dict(OPTS),
        alpha=AlphaScheduler(scheme="double_exponential", alpha_max=1e5),
        prev_coeffs=lambda xs: {"psi_k": dp.field_to_coeff(xs, "psi"),
                                "u_k": dp.field_to_coeff(xs, "u")},
        tol=1e-50, max_iterations=3, verbose=False).solve(
            dp.scatter(np.zeros(prob.space.num_dofs)))
    return res.newton_steps, float(dlp.norm(res.x))


def _launch(tmp_path, source, timeout):
    """Two children on gloo, each with its own timeout; returns their
    outputs after checking both exited 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(source)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, str(script)], env=dict(env, RANK=str(r)),
        cwd=os.getcwd(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        outs.append(out)
    assert all(pr.returncode == 0 for pr in procs), "\n---\n".join(outs)
    return outs


def test_two_process_psum(tmp_path):
    outs = _launch(tmp_path, _PSUM, 300)
    assert any("MULTIHOST_OK 6.0" in o for o in outs), "\n---\n".join(outs)


def test_two_process_lvpp_obstacle(tmp_path):
    """Two processes x two subdomains: Newton counts and ||x|| equal to
    the one-process four-subdomain run and to the reference's
    single-process run (counts identical, ||x|| within 1e-7 relative,
    the reference test's bound)."""
    import jax.numpy as jnp
    from proximalgalerkin_tpu.mesh.unstructured import create_disk_mesh
    from proximalgalerkin_tpu.models.obstacle import setup_obstacle_problem
    from proximalgalerkin_tpu.solve.lvpp import AlphaScheduler, LVPPSolver

    from proximalgalerkin_torch.parallel.comm import ShardComm

    outs = _launch(tmp_path, _LVPP, 540)
    line = next((ln for o in outs for ln in o.splitlines()
                 if ln.startswith("LVPP_MULTIHOST")), None)
    assert line is not None, "\n---\n".join(outs)
    counts, xnorm = json.loads(line.split(" ", 1)[1])

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one_counts, one_norm = lvpp_run(ShardComm(4, "cpu"))
    finally:
        torch.set_num_threads(n)

    prob = setup_obstacle_problem(create_disk_mesh(0.25), polynomial_order=1,
                                  verbose=False)
    space = prob.space
    psi_sl, u_sl = space.slice_of("psi"), space.slice_of("u")
    ref = LVPPSolver(
        prob.problem, newton_options=dict(OPTS),
        alpha=AlphaScheduler(scheme="double_exponential", alpha_max=1e5),
        prev_coeffs=lambda x_k: {"psi_k": x_k[psi_sl], "u_k": x_k[u_sl]},
        tol=1e-50, max_iterations=3, verbose=False).solve(
            jnp.zeros(space.num_dofs))
    ref_norm = float(jnp.linalg.norm(ref.x))
    assert counts == one_counts == ref.newton_steps
    assert abs(xnorm - one_norm) <= 1e-12 * one_norm
    assert abs(xnorm - ref_norm) < 1e-7 * max(ref_norm, 1.0)
