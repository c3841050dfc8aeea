"""Example 02 — Signorini contact (vector elasticity, boundary latent), in
PyTorch.

The port of the reference package's models/signorini.py
(examples/02_signorini/signorini_dolfinx.py): linear elasticity of a
half-disk (or half-sphere) pressed onto a rigid plane, with the
non-penetration constraint u·n_g <= g on the contact boundary enforced by
an exp latent variable that lives ONLY on the contact facets (the
reference's boundary submesh + cross-mesh blocked assembly, :199-291;
here a TraceSpace + composite volume/facet assembly). Residual (:244-249):

  volume:  alpha sigma(u):eps(v) dx - alpha f.v dx
  ds(contact): -(psi - psi_k)(v.n_g) + (u.n_g + exp(psi) - g) w

with n_g = -e_y the rigid-plane direction, g = x_y - gap. Alpha schemes
constant/linear/doubling (:324-329, default doubling from alpha_0=0.005),
termination on ||u - u_prev||_2 (:337-339), penetration observable
sqrt(int max(u.n_g - g, 0)^2 ds) (:309-314).

The forms live on `device` (the card unless the caller asks for the CPU);
each Newton step assembles the element matrices there and factors the
composite system with SuperLU on the host, as the reference does on one
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..assembly import VolumeForm
from ..assembly.facets import FacetForm
from ..core.config import SolverOptions
from ..core.logging import PhaseTimer, rank_print
from ..mesh.parametric import create_half_disk
from ..mesh.unstructured import TaggedMesh
from ..solve.composite import CompositeProblem
from ..solve.newton import NewtonSolver
from ..spaces import DirichletBC, FunctionSpace, MixedSpace
from ..spaces.trace import TraceSpace


@dataclass
class SignoriniResult:
    u: np.ndarray            # (n, gdim) displacement at scalar dofs
    psi: np.ndarray
    lvpp_iterations: int
    newton_iterations: List[int]
    penetrations: List[float]
    converged: bool
    von_mises: Optional[np.ndarray] = None   # per-cell (DG0) von Mises


def solve_signorini(
    tagged: Optional[TaggedMesh] = None,
    res: float = 0.04,
    degree: int = 1,
    E: float = 2e4,
    nu: float = 0.3,
    gap: float = 0.02,
    disp: float = -0.10,
    alpha_scheme: str = "doubling",
    alpha_0: float = 0.005,
    alpha_c: float = 1.0,
    max_iterations: int = 25,
    tol: float = 1e-6,
    newton_tol: float = 1e-6,
    newton_max_its: int = 50,
    quadrature_degree: int = 4,
    solver_options: Optional[dict] = None,
    verbose: bool = True,
    *,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> SignoriniResult:
    """Half-disk pressed down by `disp` onto the plane y = gap... the
    reference's run of record uses degree 2, alpha_0=0.005 doubling, disp
    in {-0.10, -0.15, -0.20} (examples/02_signorini/README.md:28-30).
    timer: a PhaseTimer that the Newton solver adds to (residual,
    assembly, host_transfer, csr, lu_factor, lu_solve, ...)."""
    device = torch.device(device)
    f64 = torch.float64
    tagged = tagged if tagged is not None else create_half_disk(res=res)
    mesh = tagged.mesh
    gdim = mesh.gdim
    contact_facets = tagged.facets("contact")
    disp_facets = tagged.facets("displacement")

    Vu = FunctionSpace.create(mesh, degree, value_size=gdim)
    Wpar = FunctionSpace.create(mesh, degree)
    trace = TraceSpace(Wpar, contact_facets)

    space_vol = MixedSpace([("u", Vu)])
    space_all = MixedSpace([("u", Vu), ("psi", trace)])

    mu = E / (2.0 * (1.0 + nu))
    lmbda = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    n_g = np.zeros(gdim)
    n_g[-1] = -1.0
    n_g_t = torch.as_tensor(n_g, dtype=f64, device=device)
    eye = torch.eye(gdim, dtype=f64, device=device)

    def vol_residual(x, u, gu, c, gc, consts):
        alpha = consts["alpha"]
        eps_u = 0.5 * (gu["u"] + gu["u"].T)
        sigma = 2.0 * mu * eps_u + lmbda * torch.trace(eps_u) * eye
        return {"u": (None, alpha * sigma)}

    vol_form = VolumeForm(space_vol, vol_residual, quadrature_degree,
                          device=device)

    def facet_residual(x, u, gu, c, gc, n, consts):
        g = x[gdim - 1] - gap
        un = torch.dot(u["u"], n_g_t)
        # overflow-safe exp: inexact (Krylov) Newton directions can
        # overshoot psi transiently; a huge-but-finite residual lets the
        # next step recover where exp(inf) would poison the solve
        psi_c = torch.clamp(u["psi"], max=45.0)
        return {
            "u": -(u["psi"] - c["psi_k"]) * n_g_t,
            # psi-row NEGATED relative to the reference's sign convention
            # (signorini_dolfinx.py:244-249): same zeros, same |F|, same
            # Newton steps, but the facet Jacobian block becomes SYMMETRIC
            # ([[0, -M],[-M, -e^psi M]] instead of [[0,-M],[+M, e^psi M]]),
            # which makes the full saddle system MINRES-admissible
            "psi": -(un + torch.exp(psi_c) - g),
        }

    # Regularized Jacobian for iterative (Krylov) solves: deep off-contact
    # the latent diagonal -exp(psi) M underflows and the saddle system is
    # numerically singular — exactly the case direct LU pivots through.
    # The reference's own recipe is an eps-mass Jacobian regularization
    # (fracture_dolfinx.py:132-138); eps=1e-8 bounds the block's diagonal
    # while leaving Newton directions accurate to O(eps).
    opts_peek = dict(solver_options or {})
    iterative = opts_peek.get("ksp_type", "preonly") not in ("preonly",) \
        and opts_peek.get("pc_type", "lu") != "lu"

    def facet_jacobian(x, u, gu, c, gc, n, consts):
        out = facet_residual(x, u, gu, c, gc, n, consts)
        out["psi"] = out["psi"] - 1e-8 * u["psi"]
        return out

    facet_form = FacetForm(space_all, contact_facets, facet_residual,
                           quadrature_degree,
                           jacobian_fn=facet_jacobian if iterative else None,
                           device=device)

    # Dirichlet: full displacement vector (0, disp) on the flat top (:261-270)
    disp_dofs = Vu.facet_closure_dofs(disp_facets)
    disp_vals = np.zeros(len(disp_dofs))
    disp_vals[np.asarray(disp_dofs) % gdim == gdim - 1] = disp
    bcs = [DirichletBC("u", disp_dofs, disp_vals)]

    problem = CompositeProblem(
        space_all, vol_form, [facet_form], bcs, coeffs={},
        consts={"alpha": torch.tensor(alpha_0, dtype=f64, device=device)})

    opts = {"snes_linesearch_type": "none", "snes_rtol": newton_tol,
            "snes_atol": 1e-50, "snes_max_it": newton_max_its,
            "ksp_type": "preonly", "pc_type": "lu"}
    opts.update(solver_options or {})
    newton = NewtonSolver(problem, SolverOptions(opts), timer=timer)

    pen_fn = facet_form.make_functional(
        lambda x, u, gu, c, gc, n, k:
        torch.clamp(torch.dot(u["u"], n_g_t) - (x[gdim - 1] - gap),
                    min=0.0) ** 2)

    u_sl = space_all.slice_of("u")
    psi_sl = space_all.slice_of("psi")

    # psi_k enters the facet form as a quadrature coefficient: evaluate the
    # trace field at the facet quadrature points
    tab_psi = facet_form.facet_data["tab"]["psi"]
    gidx_psi = facet_form.facet_data["gather_idx"]["psi"][:, :, 0]

    def psi_k_quad(x_k):
        return torch.einsum("nqi,ni->nq", tab_psi, x_k[gidx_psi])

    x = torch.as_tensor(space_all.zeros(), dtype=f64, device=device)
    x_prev = x
    newton_its: List[int] = []
    penetrations: List[float] = []
    converged = False
    it = 0
    for it in range(1, max_iterations + 1):
        if alpha_scheme == "constant":
            a = alpha_0
        elif alpha_scheme == "linear":
            a = alpha_0 + alpha_c * (it - 1)
        else:
            a = alpha_0 * 2.0 ** (it - 1)
        problem.update(facet_coeffs={"psi_k": psi_k_quad(x_prev)},
                       consts={"alpha": torch.tensor(a, dtype=f64,
                                                     device=device)})
        res_n = newton.solve(x)
        if not res_n.converged:
            rank_print(f"  Newton failed ({res_n.reason.name}); stopping")
            break
        x = res_n.x
        newton_its.append(res_n.iterations)
        pen2, diff = torch.stack([
            pen_fn(x, problem.facet_coeffs, problem.consts),
            torch.linalg.norm(x[u_sl] - x_prev[u_sl])]).tolist()
        pen = float(np.sqrt(max(pen2, 0.0)))
        penetrations.append(pen)
        if verbose:
            rank_print(f"it={it} alpha={a:.4g} newton={res_n.iterations} "
                       f"|du|={diff:.3e} penetration={pen:.3e}")
        if diff < tol:
            converged = True
            break
        x_prev = x

    # von Mises stress per cell (reference output, signorini_dolfinx.py:
    # 296-302): s = sigma - tr(sigma)/3 I, vm = sqrt(3/2 s:s)
    _, grads = vol_form._eval_field("u", x[u_sl], vol_form.cell_data)
    gu = grads.cpu().numpy().mean(axis=1)           # (e, gdim, gdim)
    eps_c = 0.5 * (gu + np.swapaxes(gu, 1, 2))
    tr = np.trace(eps_c, axis1=1, axis2=2)
    eye_h = np.eye(gdim)
    sig = 2 * mu * eps_c + lmbda * tr[:, None, None] * eye_h
    dev_s = sig - np.trace(sig, axis1=1, axis2=2)[:, None, None] / 3.0 * eye_h
    vm = np.sqrt(1.5 * np.einsum("eij,eij->e", dev_s, dev_s))

    n_scalar = Vu.num_scalar_dofs
    x_h = x.cpu().numpy()
    return SignoriniResult(
        u=x_h[u_sl].reshape(n_scalar, gdim),
        psi=x_h[psi_sl],
        lvpp_iterations=it,
        newton_iterations=newton_its,
        penetrations=penetrations,
        converged=converged,
        von_mises=vm)
