"""The port's Krylov solvers (la/krylov.py) and device Newton directions
(solve/nonlinear.py) against the reference's, on the CPU: every solver on
the dense systems of tests/test_krylov.py with x to 1e-10, MINRES
iteration counts identical, the chunked device loop equal to the
unchunked one, and the reference tests' Newton-direction protocols
(tests/test_krylov.py:103 and :184)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proximalgalerkin_tpu.la import krylov as ref
from proximalgalerkin_torch.la import krylov
from proximalgalerkin_torch.core.logging import counter

f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    torch's thread pool slows many times over when the test workers
    already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _systems():
    rng = np.random.default_rng(0)
    n = 200
    A = np.diag(np.linspace(1, 50, n)) \
        + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = A @ rng.standard_normal(n)
    B = np.diag(np.linspace(0.5, 80, 120))
    B[0, 119] = 5.0
    bb = np.random.default_rng(1).standard_normal(120)
    rng = np.random.default_rng(2)
    Q = np.linalg.qr(rng.standard_normal((80, 80)))[0]
    S = Q @ np.diag(np.concatenate([np.linspace(1, 10, 40),
                                    -np.linspace(1, 4, 40)])) @ Q.T
    bs = rng.standard_normal(80)
    P = Q @ np.diag(np.linspace(1, 30, 80)) @ Q.T
    return {"nonsym": (A, b), "restarts": (B, bb), "indefinite": (S, bs),
            "spd": (P, bs)}


SYSTEMS = _systems()

# (solver, system, kwargs): the configurations of tests/test_krylov.py and
# the reference's jax.scipy-backed solvers on the same matrices
CASES = [
    ("gmres_givens", "nonsym", dict(tol=1e-12, maxiter=2000, restart=40)),
    ("gmres_givens", "nonsym", dict(tol=1e-12, maxiter=2000, restart=40,
                                    Minv_diag="jacobi")),
    ("gmres_givens", "restarts", dict(tol=1e-11, maxiter=1000, restart=15)),
    ("gmres", "nonsym", dict(tol=1e-12, maxiter=100)),
    ("gmres", "restarts", dict(tol=1e-11, maxiter=100, restart=15)),
    ("bicgstab", "nonsym", dict(tol=1e-12, maxiter=2000)),
    ("cg", "spd", dict(tol=1e-12, maxiter=2000)),
    ("cg", "spd", dict(tol=1e-12, maxiter=2000, M="jacobi")),
    ("minres", "indefinite", dict(tol=1e-12, maxiter=1000)),
    ("minres", "spd", dict(tol=1e-12, maxiter=1000, Minv_diag="jacobi")),
]


def _kw(kw, A, pkg):
    out = dict(kw)
    conv = jnp.asarray if pkg == "ref" else torch.tensor
    d = 1.0 / np.abs(np.diag(A))
    if out.get("Minv_diag") == "jacobi":
        out["Minv_diag"] = conv(d)
    if out.get("M") == "jacobi":
        dd = conv(d)
        out["M"] = lambda v: dd * v
    return out


@pytest.mark.parametrize("case", range(len(CASES)))
def test_solver_matches_reference(case):
    name, system, kw = CASES[case]
    A, b = SYSTEMS[system]
    Aj, At = jnp.asarray(A), torch.tensor(A)
    x_ref = np.asarray(getattr(ref, name)(lambda v: Aj @ v, jnp.asarray(b),
                                          **_kw(kw, A, "ref")))
    x = getattr(krylov, name)(lambda v: At @ v, torch.tensor(b),
                              **_kw(kw, A, "port")).numpy()
    assert np.abs(x - x_ref).max() <= 1e-10
    assert np.linalg.norm(A @ x - b) <= 1e-9 * np.linalg.norm(b)


def test_krylov_table_names_every_solver():
    assert set(krylov.KRYLOV) == set(ref.KRYLOV)


@pytest.mark.parametrize("system,minv", [("indefinite", None),
                                         ("indefinite", "half"),
                                         ("spd", "jacobi")])
def test_minres_info_counts_match_reference(system, minv):
    A, b = SYSTEMS[system]
    Aj, At = jnp.asarray(A), torch.tensor(A)
    kr, kt = {}, {}
    if minv == "half":
        kr["Minv"] = lambda v: 0.5 * v
        kt["Minv"] = lambda v: 0.5 * v
    elif minv == "jacobi":
        kr["Minv_diag"] = jnp.asarray(1.0 / np.abs(np.diag(A)))
        kt["Minv_diag"] = torch.tensor(1.0 / np.abs(np.diag(A)))
    xr, rr, ir = ref.minres_info(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                                 maxiter=1000, **kr)
    xt, rt, it = krylov.minres_info(lambda v: At @ v, torch.tensor(b),
                                    tol=1e-12, maxiter=1000, **kt)
    assert int(it) == int(ir)
    assert np.abs(xt.numpy() - np.asarray(xr)).max() <= 1e-10
    assert abs(float(rt) - float(rr)) <= 1e-10 * float(np.linalg.norm(b))


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_chunked_loop_equals_unchunked(chunk):
    """The masked chunks leave the iteration count and the iterate of the
    plain loop (chunk 1) unchanged, and read the host once per chunk."""
    A, b = SYSTEMS["indefinite"]
    At = torch.tensor(A)
    x1, r1, i1 = krylov.minres_info(lambda v: At @ v, torch.tensor(b),
                                    tol=1e-12, maxiter=1000, chunk=1)
    before = counter("host_reads")
    x, r, i = krylov.minres_info(lambda v: At @ v, torch.tensor(b),
                                 tol=1e-12, maxiter=1000, chunk=chunk)
    reads = counter("host_reads") - before
    assert int(i) == int(i1) and torch.equal(x, x1) and torch.equal(r, r1)
    expected = int(i) + 1 if chunk == 1 else math.ceil(int(i) / chunk)
    assert reads == expected
    # maxiter inside a chunk stops the loop exactly there
    _, _, i7 = krylov.minres_info(lambda v: At @ v, torch.tensor(b),
                                  tol=1e-30, maxiter=7, chunk=chunk)
    assert int(i7) == 7


def _obstacle_pair(n, p):
    from proximalgalerkin_tpu.mesh import rectangle_mesh as RM
    from proximalgalerkin_tpu.models.obstacle import setup_obstacle_problem as RS
    from proximalgalerkin_torch.mesh import rectangle_mesh
    from proximalgalerkin_torch.models.obstacle import setup_obstacle_problem
    kw = dict(polynomial_order=p, verbose=False)
    return (RS(RM(n, n, p0=(-1.0, -1.0), p1=(1.0, 1.0)), **kw),
            setup_obstacle_problem(rectangle_mesh(n, n, p0=(-1.0, -1.0),
                                                  p1=(1.0, 1.0)),
                                   device="cpu", **kw))


def _three_outer(prob, opts_cls, newton_cls, sched, zeros, scalar, fused):
    base = {"snes_rtol": 1e-6, "snes_max_it": 50,
            "snes_linesearch_type": "none",
            "ksp_type": "minres", "pc_type": "jacobi", "mat_type": "ell",
            "ksp_rtol": 1e-11, "ksp_atol": 0.0, "ksp_max_it": 10000}
    p, space = prob.problem, prob.space
    psi_sl, u_sl = space.slice_of("psi"), space.slice_of("u")
    sched.reset()
    x = zeros(space.num_dofs)
    x_k, its = x, []
    for k in range(3):
        p.update(coeffs={"psi_k": x_k[psi_sl], "u_k": x_k[u_sl]},
                 consts={"alpha": scalar(sched.value(k))})
        r = newton_cls(p, opts_cls(dict(base, snes_fused=fused))).solve(x)
        assert r.converged, r.reason
        its.append(r.iterations)
        x = x_k = r.x
    return its, np.asarray(x) if not isinstance(x, torch.Tensor) \
        else x.numpy()


def test_fused_newton_matches_host_loop_and_reference_obstacle_p2():
    """P2 at 12^2, minres/jacobi/ell, three LVPP outers (the reference's
    tests/test_krylov.py:103): the port's host Newton loop and its fused
    device loop give the reference's Newton counts, and x within 1e-9 of
    the reference's."""
    from proximalgalerkin_tpu.core.config import SolverOptions as RO
    from proximalgalerkin_tpu.solve import AlphaScheduler as RA
    from proximalgalerkin_tpu.solve.newton import NewtonSolver as RN
    from proximalgalerkin_torch.core.config import SolverOptions
    from proximalgalerkin_torch.solve import AlphaScheduler, NewtonSolver
    rp, tp = _obstacle_pair(12, 2)
    its_r, x_r = _three_outer(rp, RO, RN, RA(scheme="double_exponential",
                                             alpha_max=1e5),
                              lambda n: jnp.zeros(n), jnp.asarray, False)
    sched = AlphaScheduler(scheme="double_exponential", alpha_max=1e5)
    scalar = lambda a: torch.tensor(a, dtype=f64)
    zeros = lambda n: torch.zeros(n, dtype=f64)
    its_h, x_h = _three_outer(tp, SolverOptions, NewtonSolver, sched, zeros,
                              scalar, False)
    its_f, x_f = _three_outer(tp, SolverOptions, NewtonSolver, sched, zeros,
                              scalar, True)
    assert its_h == its_f == its_r
    assert np.abs(x_h - x_f).max() <= 1e-9
    assert np.abs(x_h - x_r).max() <= 1e-9


def _first_direction(prob, lib):
    p, space = prob.problem, prob.space
    nv = space.spaces["u"].num_dofs
    if lib == "ref":
        p.update(coeffs={"psi_k": jnp.zeros(nv), "u_k": jnp.zeros(nv)})
        x = jnp.asarray(p.set_bc(space.zeros()))
    else:
        p.update(coeffs={"psi_k": torch.zeros(nv, dtype=f64),
                         "u_k": torch.zeros(nv, dtype=f64)})
        x = p.set_bc(space.zeros())
    return p, x, p.residual(x)


def test_mixed_precision_direction_obstacle():
    """ksp_precision='mixed' (f32 equilibrated inner MINRES + f64
    refinement, tests/test_krylov.py:184) on the 10^2 P1 obstacle: the
    port's direction agrees with the reference's and with host LU, and its
    refinement passes read the host once each."""
    import scipy.sparse.linalg as spla
    rp, tp = _obstacle_pair(10, 1)
    pr, xr, Fr = _first_direction(rp, "ref")
    pt, xt, Ft = _first_direction(tp, "port")
    dx_ref = np.asarray(pr.direction_solver(
        "minres", "jacobi", "ell", precision="mixed")(
            xr, Fr, pr.coeffs, pr.consts, 1e-10, 1e-12, 20000))
    A = pt.jacobian_scipy(xt)
    dx_lu = spla.splu(A.tocsc()).solve(-Ft.numpy())
    step = pt.direction_solver("minres", "jacobi", "ell", precision="mixed")
    dx = step(xt, Ft, pt.coeffs, pt.consts, 1e-10, 1e-12, 20000).numpy()
    assert np.linalg.norm(dx - dx_lu) / np.linalg.norm(dx_lu) < 1e-7
    assert np.linalg.norm(dx - dx_ref) / np.linalg.norm(dx_ref) < 1e-7
    with pytest.raises(ValueError, match="mixed"):
        pt.direction_solver("minres", "none", "ell", precision="mixed")


@pytest.mark.parametrize("ksp,mat_type", [("minres", "matfree"),
                                          ("cg", "ell"), ("gmres", "ell"),
                                          ("bicgstab", "ell"),
                                          ("gmres_d", "matfree")])
def test_double_directions_match_reference(ksp, mat_type):
    """f64 equilibrated directions on the 8^2 P1 obstacle Jacobian against
    the reference's direction_solver with the same options."""
    rp, tp = _obstacle_pair(8, 1)
    pr, xr, Fr = _first_direction(rp, "ref")
    pt, xt, Ft = _first_direction(tp, "port")
    dx_ref = np.asarray(pr.direction_solver(ksp, "jacobi", mat_type)(
        xr, Fr, pr.coeffs, pr.consts, 1e-12, 0.0, 5000))
    dx = pt.direction_solver(ksp, "jacobi", mat_type)(
        xt, Ft, pt.coeffs, pt.consts, 1e-12, 0.0, 5000).numpy()
    assert np.abs(dx - dx_ref).max() <= 1e-10 * np.abs(dx_ref).max()


def test_equilibrated_direction_thermoforming():
    """bicgstab and gmres_d equilibrated directions match host LU on the
    nonsymmetric thermoforming Jacobian (tests/test_krylov.py:58)."""
    import scipy.sparse.linalg as spla
    from proximalgalerkin_torch.assembly import VolumeForm
    from proximalgalerkin_torch.mesh import unit_square_mesh
    from proximalgalerkin_torch.solve import NonlinearProblem
    from proximalgalerkin_torch.spaces import (DirichletBC, FunctionSpace,
                                               MixedSpace)
    M, q_bound, beta, f = 12, 0.01, 1.0, 25.0
    mesh = unit_square_mesh(M, M)
    V = FunctionSpace.create(mesh, 1)
    space = MixedSpace([("u", V), ("T", V), ("psi", V)])

    def g(s):
        return torch.clamp(1.0 - s / q_bound, 0.0, 1.0)

    def residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        expm = torch.exp(-torch.clamp(u["psi"], -45.0, 45.0))
        mould = 1.0 - 2.0 * torch.maximum(torch.abs(x[0] - 0.5),
                                          torch.abs(x[1] - 0.5))
        xi = torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])
        return {"u": (u["psi"] - c["psi_prev"] - alpha * f,
                      alpha * gu["u"]),
                "T": (beta * u["T"] - g(expm), gu["T"]),
                "psi": (u["u"] + expm - (mould + xi * u["T"]), None)}

    form = VolumeForm(space, residual, 3, coeff_spaces={"psi_prev": V},
                      device="cpu")
    p = NonlinearProblem(form, [DirichletBC.from_marker("u", V, value=0.0)],
                         consts={"alpha": torch.tensor(2.0 ** -6, dtype=f64)})
    p.update(coeffs={"psi_prev": torch.zeros(V.num_dofs, dtype=f64)})
    x = p.set_bc(space.zeros())
    F = p.residual(x)
    dx_lu = spla.splu(p.jacobian_scipy(x).tocsc()).solve(-F.numpy())
    for ksp in ("bicgstab", "gmres_d"):
        step = p.direction_solver(ksp, "jacobi", "ell")
        dx = step(x, F, p.coeffs, p.consts, 1e-11, 1e-13, 20000).numpy()
        assert np.linalg.norm(dx - dx_lu) / np.linalg.norm(dx_lu) < 1e-7, ksp


def test_unported_solvers_raise():
    """No Newton direction is left unported: the block-Schur
    preconditioners (A10) and the A9 entry points (pc_type='btlu',
    fused_newton_btlu, EllSplit) run — a schur, schur_mg or btlu
    direction solves the system and the Newton solve converges — and the
    block-Schur directions refuse what the reference refuses, with its
    messages."""
    import scipy.sparse.linalg as spla
    from proximalgalerkin_torch.core.config import SolverOptions
    from proximalgalerkin_torch.solve import NewtonSolver
    from proximalgalerkin_torch.solve.nonlinear import EllSplit
    rp, tp = _obstacle_pair(4, 1)
    for prob in (rp.problem, tp.problem):
        with pytest.raises(ValueError, match="requires mat_type='ell' and "
                                             "ksp='minres'"):
            prob.direction_solver("cg", "schur")
        with pytest.raises(ValueError, match="one scalar block1 field"):
            prob.direction_solver("minres", "schur_mg",
                                  schur_field0="u, psi")
    p = tp.problem
    assert callable(p.fused_newton_btlu())
    assert EllSplit(None, None, {}).extra == {}
    p, x, F = _first_direction(tp, "port")
    dx_lu = spla.splu(p.jacobian_scipy(x).tocsc()).solve(-F.numpy())
    for pc in ("schur", "schur_mg"):
        dx = p.direction_solver("minres", pc, schur_field0="psi")(
            x, F, p.coeffs, p.consts, 1e-12, 0.0, 2000).numpy()
        assert np.linalg.norm(dx - dx_lu) / np.linalg.norm(dx_lu) < 1e-9
    dx = p.direction_solver("minres", "btlu")(x, F, p.coeffs, p.consts,
                                              1e-12, 0.0, 100).numpy()
    assert np.linalg.norm(dx - dx_lu) / np.linalg.norm(dx_lu) < 1e-9
    assert NewtonSolver(p, SolverOptions({"ksp_type": "minres",
                                          "pc_type": "btlu"})).solve(
        x).converged
