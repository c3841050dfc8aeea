"""One matrix-free Jacobian action of the eikonal 24x4 problem (the
LVPP system of models/eikonal.py at its first step) in the PyTorch port
and in the JAX package, on the CPU:

    python scripts/matfree_action_cpu.py

prints the milliseconds of the port's eager `torch.func.jvp` action (one
intra-op thread), of its residual alone, the number of aten ops one
action dispatches, the milliseconds of the JAX package's `jit(jvp)`
action, and the largest difference between the two actions on the same
random x and v (made with numpy from a seed).
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.func import jvp  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


class _Stop(Exception):
    pass


def first_problem(package: str, solve, **kw):
    """The NonlinearProblem that `solve` hands its Newton solver first."""
    import importlib
    newton = importlib.import_module(package + ".solve.newton")
    real = newton.NewtonSolver.solve
    seen = []

    def grab(solver, x0):
        seen.append(solver.problem)
        raise _Stop

    newton.NewtonSolver.solve = grab
    try:
        solve(ns=24, nt=4, verbose=False, **kw)
    except _Stop:
        pass
    finally:
        newton.NewtonSolver.solve = real
    return seen[0]


def per_call_ms(fn, calls: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def main():
    from proximalgalerkin_torch.models.eikonal import solve_eikonal
    from proximalgalerkin_tpu.models.eikonal import \
        solve_eikonal as ref_solve_eikonal
    torch.set_num_threads(1)
    p = first_problem("proximalgalerkin_torch", solve_eikonal, device="cpu")
    rp = first_problem("proximalgalerkin_tpu", ref_solve_eikonal)
    n = p.form.space.num_dofs
    rng = np.random.default_rng(0)
    xn, vn = 0.1 * rng.normal(size=n), rng.normal(size=n)

    x, v = torch.tensor(xn), torch.tensor(vn)

    def f(y):
        return p.form._jacobian_residual_core(y, p.coeffs, p.consts)

    def action():
        return jvp(f, (x,), (v,))[1]

    print(f"dofs {n}, cells {p.form.cell_data['wdet'].shape[0]}")
    print(f"port, eager torch.func.jvp action: "
          f"{per_call_ms(action, 20):.3f} ms")
    print(f"port, residual alone: {per_call_ms(lambda: f(x), 20):.3f} ms")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        action()
    ops = sum(e.count for e in prof.key_averages()
              if e.key.startswith("aten::"))
    print(f"port, aten ops in one action: {ops}")

    def rf(y):
        return rp.form._jacobian_residual_core(y, rp.coeffs, rp.consts)

    ract = jax.jit(lambda y, w: jax.jvp(rf, (y,), (w,))[1])
    rx, rv = jnp.asarray(xn), jnp.asarray(vn)
    print(f"JAX package, jit(jvp) action: "
          f"{per_call_ms(lambda: ract(rx, rv).block_until_ready(), 200):.3f}"
          " ms")
    diff = np.abs(action().numpy() - np.asarray(ract(rx, rv))).max()
    print(f"max |port - JAX package| of the action: {diff:.3e}")


if __name__ == "__main__":
    main()
