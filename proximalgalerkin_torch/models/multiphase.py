"""Example 04 — four-species multiphase Cahn–Hilliard gradient flow, in
PyTorch.

The port of the reference package's models/multiphase.py
(examples/04_multiphase/multiphase_dolfinx.py): mixed (u, z, psi) with
each field a 4-vector P1 function (:38-43), simplex constraint
(u_m >= 0, sum_m u_m = 1) via the softmax latent map
u_m = exp(psi_m)/sum exp(psi) (:83-90), implicit Euler stepping (:75-78),
per-step latent warm start psi_i = ln(|u_i| + 1e-7) + 1 (:183-196), and
alpha schemes constant/linear/doubling capped at alpha_max (:203-205).

Residual (Einstein-index forms :64-90), per test field:
  z-row:   alpha<z, y> + eps^2 alpha <grad u, grad y> - 2 alpha <u, y>
           + <psi - psi_old, y> - alpha <1, y>
  u-row:   <u - u_prev, v> - tau <grad z, grad v>
  psi-row: <u - softmax(psi) - eps0 psi, w>

Only -softmax(psi) is not affine, so the Jacobian splits into a part
that is constant per (alpha, tau) and the softmax block: the host LU path
reads it through `csr_data_override`, the fused lagged-btlu path through
an `EllSplit` with the closed-form softmax Jacobian.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..assembly import VolumeForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer, rank_print
from ..mesh.generation import unit_square_mesh
from ..native import scatter_add
from ..solve import NonlinearProblem
from ..solve.newton import NewtonSolver
from ..solve.nonlinear import EllSplit
from ..spaces import FunctionSpace, MixedSpace
from ..utils.checkpoint import LVPPCheckpoint
from .fracture import _circumradius

NUM_SPECIES = 4


def initial_condition(V: FunctionSpace) -> np.ndarray:
    """The reference's three-region initial layout (:92-125): species 0
    everywhere, species 1 in a rectangle, species 2/3 in its lower halves.
    Applied cell-wise (all dofs of cells inside each region)."""
    mesh = V.mesh
    n = V.num_scalar_dofs
    u = np.zeros(n * NUM_SPECIES)
    u[0::NUM_SPECIES] = 1.0

    def cells_where(marker):
        ok = marker(mesh.points.T)
        return np.flatnonzero(np.all(ok[mesh.cell_vertices], axis=1))

    def set_species(cells, species):
        dofs = np.unique(V.dofmap[cells].reshape(-1))
        base = dofs * NUM_SPECIES
        for m in range(NUM_SPECIES):
            u[base + m] = 1.0 if m == species else 0.0

    tol = 1e-14
    rect = cells_where(lambda x: (0.2 - tol <= x[1]) & (x[1] <= 0.75 + tol)
                       & (0.2 - tol <= x[0]) & (x[0] <= 0.8 + tol))
    low_l = cells_where(lambda x: (x[1] <= 0.5 + tol) & (0.2 - tol <= x[1])
                        & (0.2 - tol <= x[0]) & (x[0] <= 0.5 + tol))
    low_r = cells_where(lambda x: (x[1] <= 0.5 + tol) & (0.2 <= x[1] + tol)
                        & (0.5 - tol <= x[0]) & (x[0] <= 0.8 + tol))
    set_species(rect, 1)
    set_species(low_l, 2)
    set_species(low_r, 3)
    return u


@dataclass
class MultiphaseResult:
    u: np.ndarray
    newton_iterations: np.ndarray
    lvpp_iterations: np.ndarray
    mass_history: List[np.ndarray] = field(default_factory=list)
    # block-tridiagonal factorizations per time step (pc_type='btlu')
    refactors_per_step: Optional[np.ndarray] = None


def solve_multiphase(
    N: int = 50,
    M: int = 50,
    primal_degree: int = 1,
    cell_type: str = "triangle",
    alpha_max: float = 50.0,
    alpha_scheme: str = "constant",
    alpha_0: float = 1.0,
    alpha_c: float = 1.0,
    max_iterations: int = 20,
    stopping_tol: float = 1e-5,
    tau0: float = 1e-5,
    T: float = 7e-3,
    solver_options: Optional[dict] = None,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    progress_jsonl: Optional[str] = None,
    *,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> MultiphaseResult:
    """checkpoint_path: npz snapshot (utils/checkpoint.LVPPCheckpoint, the
    reference's layout) written every checkpoint_every time steps and
    loaded on entry if present; progress_jsonl appends one JSON line per
    completed implicit-Euler step. device: the torch device of the solve;
    timer: a PhaseTimer the Newton solver adds its phases to."""
    device = torch.device(device)
    f64 = torch.float64
    mesh = unit_square_mesh(N, M, cell_type=cell_type, diagonal="crossed")
    C = FunctionSpace.create(mesh, primal_degree, value_size=NUM_SPECIES)
    space = MixedSpace([("u", C), ("z", C), ("psi", C)])

    eps0 = 1e-9

    def residual(x, u, gu, c, gc, consts):
        alpha, tau = consts["alpha"], consts["tau"]
        eps2 = c["eps"] ** 2
        uu, zz, psi = u["u"], u["z"], u["psi"]
        softmax = torch.softmax(psi, dim=-1)
        a0_z = (alpha * zz - 2.0 * alpha * uu + psi - c["psi_old"]
                - alpha * torch.ones_like(uu))
        a1_z = eps2 * alpha * gu["u"]
        a0_u = uu - c["u_prev"]
        a1_u = -tau * gu["z"]
        a0_psi = uu - softmax - eps0 * psi
        return {"u": (a0_u, a1_u), "z": (a0_z, a1_z), "psi": (a0_psi, None)}

    form = VolumeForm(space, residual, quadrature_degree=2 * primal_degree + 1,
                      coeff_spaces={"u_prev": C, "psi_old": C, "u_old": C},
                      device=device)

    def residual_nl(x, u, gu, c, gc, consts):
        """The only non-affine term of `residual`: -softmax(psi) in the
        psi equation. Everything else is linear in x (u_prev/psi_old are
        coefficients, alpha/tau/eps constants), so the Jacobian splits as
        J(x) = J_lin + J_nl(psi) with J_lin constant per (alpha, tau).
        Assembled on a psi-only subspace (12x12 local blocks, the [psi,psi]
        block of the full 36x36 element matrices)."""
        return {"psi": (-torch.softmax(u["psi"], dim=-1), None)}

    space_psi = MixedSpace([("psi", C)])
    form_nl = VolumeForm(space_psi, residual_nl,
                         quadrature_degree=2 * primal_degree + 1,
                         device=device)
    # epsilon = 2h with h = 2*circumradius, a cellwise coefficient (:52-53)
    R = _circumradius(mesh)
    eps_q = np.repeat((4.0 * R)[:, None], form.nq, axis=1)

    def scalar(v):
        return torch.tensor(v, dtype=f64, device=device)

    problem = NonlinearProblem(
        form, [],
        coeffs={"eps": torch.as_tensor(eps_q, dtype=f64, device=device)},
        consts={"alpha": scalar(alpha_0), "tau": scalar(tau0)})

    u_sl = space.slice_of("u")
    psi_sl = space.slice_of("psi")

    def lin_element_matrices(coeffs, consts):
        """(e, L, L) host element matrices of the affine part (the full
        form at x = 0 minus the softmax block at psi = 0) and the size of
        the psi block."""
        ae_full = form.element_matrices(
            torch.zeros(space.num_dofs, dtype=f64, device=device), coeffs,
            consts).cpu().numpy()
        ae_nl0 = form_nl.element_matrices(
            torch.zeros(space_psi.num_dofs, dtype=f64, device=device), {},
            consts).cpu().numpy()
        nloc = ae_nl0.shape[1]
        ae_full[:, -nloc:, -nloc:] -= ae_nl0
        return ae_full, nloc

    # Split-Jacobian assembly for the host LU: the CSR data of the affine
    # part is cached once per (alpha, tau); each Jacobian re-differentiates
    # and scatters ONLY the softmax (psi,psi) block.
    _lin_cache: dict = {}

    def _csr_data_override(xx, coeffs, consts):
        key = (float(consts["alpha"]), float(consts["tau"]))
        pat = problem.ell_matrix.pattern
        if _lin_cache.get("key") != key:
            ae_full, nloc = lin_element_matrices(coeffs, consts)
            _lin_cache["lin"] = scatter_add(
                ae_full.reshape(-1).astype(np.float64),
                pat.slot_map.astype(np.int64), pat.nnz)
            ncells, L, _ = ae_full.shape
            _lin_cache["slots_nl"] = np.ascontiguousarray(
                pat.slot_map.reshape(ncells, L, L)[:, -nloc:, -nloc:]
            ).reshape(-1).astype(np.int64)
            _lin_cache["key"] = key
        ae_nl = form_nl.element_matrices(form._as(xx)[psi_sl], {},
                                         consts).cpu().numpy()
        return _lin_cache["lin"] + scatter_add(
            ae_nl.reshape(-1).astype(np.float64),
            _lin_cache["slots_nl"], pat.nnz)

    problem.csr_data_override = _csr_data_override

    # Device twin of the split (EllSplit, solve/nonlinear.py): the fused
    # btlu Newton assembles J(x) = lin_ell + nl_ell(psi) on the device
    # with a CLOSED-FORM softmax Jacobian — d(-softmax)_m/dpsi_n =
    # s_m s_n - delta_mn s_m — instead of re-differentiating all 36 local
    # dofs through jacfwd. Slot/lane maps are precomputed on the host; nl
    # entries landing on BC-killed slots scatter into a dump lane
    # (multiphase has no BCs, but the machinery stays general).
    def _install_ell_split():
        pat = problem.ell_matrix.pattern
        ncells = mesh.num_cells
        phi_psi = form.tab["psi"][0]                      # (q, i)
        nloc = NUM_SPECIES * phi_psi.shape[1]
        Lf = int(round(np.sqrt(pat.slot_map.size / ncells)))
        slots_nl = np.ascontiguousarray(
            pat.slot_map.reshape(ncells, Lf, Lf)[:, -nloc:, -nloc:]
        ).reshape(-1).astype(np.int64)
        eg = pat.ell_gather.reshape(-1).astype(np.int64)
        live = eg < pat.nnz
        dump = pat.num_dofs * pat.width
        slot_to_pos = np.full(pat.nnz, dump, np.int64)
        slot_to_pos[eg[live]] = np.flatnonzero(live)
        ell_idx = np.where(pat.keep[slots_nl] > 0.0,
                           slot_to_pos[slots_nl], dump)
        NK = int(pat.num_dofs) * int(pat.width)

        extra = {"gidx": form.gather_idx["psi"], "phi": phi_psi,
                 "wdet": form.wdet,
                 "ell_idx": torch.as_tensor(ell_idx, device=device)}
        eye = torch.eye(NUM_SPECIES, dtype=f64, device=device)

        def nl_core(x, coeffs, consts, ex):
            zc = x[ex["gidx"]]                           # (e, i, m)
            psi_q = torch.einsum("qi,eim->eqm", ex["phi"], zc)
            s = torch.softmax(psi_q, dim=-1)
            Mq = s[..., :, None] * s[..., None, :] - s[..., :, None] * eye
            Ae = torch.einsum("eq,qi,qj,eqmn->eimjn", ex["wdet"],
                              ex["phi"], ex["phi"], Mq)
            out = torch.zeros(NK + 1, dtype=Ae.dtype, device=Ae.device)
            out.index_add_(0, ex["ell_idx"], Ae.reshape(-1))
            return out[:NK].reshape(pat.num_dofs, pat.width)

        _lin_ell_cache: dict = {}

        def lin_data(coeffs, consts):
            key = (float(consts["alpha"]), float(consts["tau"]))
            if _lin_ell_cache.get("key") != key:
                ae_full, _ = lin_element_matrices(coeffs, consts)
                _lin_ell_cache["lin"] = problem.ell_matrix.assemble(
                    torch.as_tensor(ae_full, device=device))
                _lin_ell_cache["key"] = key
            return _lin_ell_cache["lin"]

        problem.ell_split = EllSplit(nl_core, lin_data, extra)

    # the reference runs snes_type=newtonls with PETSc's default cubic
    # backtracking linesearch (multiphase_dolfinx.py:128); without a
    # linesearch the softmax coupling makes full Newton oscillate
    opts = {"snes_atol": 1e-8, "snes_rtol": 1e-8, "snes_max_it": 25,
            "ksp_type": "preonly", "pc_type": "lu",
            "snes_linesearch_type": "bt"}
    opts.update(solver_options or {})
    if opts.get("snes_fused") and opts.get("pc_type") == "btlu":
        _install_ell_split()
    newton = NewtonSolver(problem, SolverOptions(opts), timer=timer)

    l2_fn = form.make_functional(
        lambda x, u, gu, c, gc, k: torch.dot(u["u"] - c["u_old"],
                                             u["u"] - c["u_old"]))
    mass_fn = form.make_functional(
        lambda x, u, gu, c, gc, k: torch.sum(u["u"]))

    u_prev = torch.as_tensor(initial_condition(C), dtype=f64, device=device)
    x = torch.zeros(space.num_dofs, dtype=f64, device=device)

    num_steps = int(np.ceil(T / tau0))
    newton_its = np.zeros(num_steps, dtype=np.int32)
    lvpp_its = np.zeros(num_steps, dtype=np.int32)
    refactors = np.zeros(num_steps, dtype=np.int32)
    masses: List[np.ndarray] = []

    start_step = 0
    if checkpoint_path is not None and Path(checkpoint_path).exists():
        ck = LVPPCheckpoint.load(checkpoint_path)
        u_prev = torch.as_tensor(ck.x, dtype=f64, device=device)
        x = torch.as_tensor(ck.x_k, dtype=f64, device=device)
        start_step = int(ck.step)
        n_done = len(ck.newton_steps)
        newton_its[:n_done] = np.asarray(ck.newton_steps,
                                         dtype=np.int32)[:num_steps]
        lv = ck.observables.get("lvpp", [])
        lvpp_its[:len(lv)] = np.asarray(lv, dtype=np.int32)[:num_steps]
        masses = [np.array([m]) for m in ck.observables.get("mass", [])]
        if verbose:
            rank_print(f"Resuming multiphase at time step {start_step}")

    def _save_ck(j):
        LVPPCheckpoint(
            x=u_prev.cpu().numpy(), x_k=x.cpu().numpy(), iteration=0,
            alpha_prev_raw=1.0, step=j,
            newton_steps=[int(v) for v in newton_its[:j]],
            observables={"lvpp": [float(v) for v in lvpp_its[:j]],
                         "mass": [float(m[0]) for m in masses]},
        ).save(checkpoint_path)

    def _emit(j, i, wall):
        if progress_jsonl is None:
            return
        with open(progress_jsonl, "a") as f:
            f.write(json.dumps(
                {"step": j, "newton": int(newton_its[j - 1]),
                 "lvpp": int(i), "mass": float(masses[-1][0]),
                 "wall_s": round(wall, 2)}) + "\n")

    for j in range(start_step + 1, num_steps + 1):
        t_step = time.time()
        refactors0 = newton.refactors
        if verbose:
            rank_print(f"Step {j}/{num_steps}")
        # latent warm start psi = ln(|u|+1e-7) + 1 (:183-196)
        psi_init = torch.log(torch.abs(u_prev) + 1e-7) + 1.0
        x = x.clone()
        x[u_sl] = u_prev
        x[psi_sl] = psi_init
        psi_old = psi_init
        u_old = torch.zeros_like(u_prev)

        for i in range(1, max_iterations + 1):
            if alpha_scheme == "constant":
                a = alpha_0
            elif alpha_scheme == "linear":
                a = min(alpha_0 + alpha_c * i, alpha_max)
            elif alpha_scheme == "doubling":
                a = min(alpha_0 * 2**i, alpha_max)
            problem.update(
                coeffs={"u_prev": u_prev, "psi_old": psi_old, "u_old": u_old},
                consts={"alpha": scalar(a)})
            res = newton.solve(x)
            if not res.converged:
                raise RuntimeError(
                    f"Newton diverged at step {j} it {i}: {res.reason.name}")
            x = res.x
            newton_its[j - 1] += res.iterations
            coeffs = dict(problem.coeffs)
            diff = float(np.sqrt(max(float(l2_fn(x, coeffs, {})), 0.0)))
            if verbose:
                rank_print(f"Iteration {i}: alpha={a:.2e} "
                           f"newton={res.iterations} |delta u|={diff:.3e}")
            u_old = x[u_sl]
            psi_old = x[psi_sl]
            if diff < stopping_tol:
                break
        lvpp_its[j - 1] = i
        refactors[j - 1] = newton.refactors - refactors0
        u_prev = x[u_sl]
        masses.append(np.array(
            [float(mass_fn(x, problem.coeffs, {}))]))
        _emit(j, i, time.time() - t_step)
        if checkpoint_path is not None and j % checkpoint_every == 0:
            _save_ck(j)

    return MultiphaseResult(u=u_prev.cpu().numpy(),
                            newton_iterations=newton_its,
                            lvpp_iterations=lvpp_its,
                            mass_history=masses,
                            refactors_per_step=refactors)

