"""Example 01's disk with the options of the JAX package's all-device
record (scripts/tpu_records.py obstacle_unstructured: btlu with an f64
factor and the 'schur' block inverse, lag 1, ksp_rtol 1e-12, alpha_max
1e4, tol 1e-8) on the CPU:

    python scripts/disk_btlu_cpu.py MODE RES

MODE is one of
  torch         the port as it is;
  torch-jacobi  the port with the JAX package's equilibration (every
                nonzero diagonal scales its row, la/blocktri.py);
  jax           the JAX package as it runs on the CPU (LAPACK block
                inverses);
  jax-tpu       the JAX package with the block inverse it runs on the
                TPU patched in (recursive Schur with f32 + Newton-Schulz
                leaves, `_block_inv_schur`);
  lu            the port with its default host LU direction.
Prints the dofs, the LVPP and Newton counts and whether the run
converged; the torch modes also print, for each block-tridiagonal
factor, the smallest |diagonal| of the Jacobian, the rows left unscaled,
the largest equilibrated entry and the largest |M_k X_k - I| over its
block inverses.
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])

OPTS = {"ksp_type": "preonly", "pc_type": "btlu", "ksp_rtol": 1e-12,
        "pc_factor_dtype": "f64", "pc_factor_blockinv": "schur",
        "pc_factor_lag": 1}


def _patch_jax_tpu_inverse():
    import jax.numpy as jnp
    from proximalgalerkin_tpu.la import blocktri

    def block_inv(M, algo="ns"):
        if M.dtype != jnp.float64:
            return jnp.linalg.inv(M)
        return (blocktri._block_inv_schur(M) if algo == "schur"
                else blocktri._block_inv_ns(M))

    blocktri._block_inv = block_inv


def _report_torch_factors(jacobi: bool):
    import torch
    from proximalgalerkin_torch.la import blocktri
    inv, factor, equilibrate = (blocktri._block_inv, blocktri.bt_factor,
                                blocktri._equilibrate)
    errs, stats = [], {}

    def reference_equilibrate(ell_data, ell_cols):
        row = torch.arange(ell_data.shape[0])[:, None]
        diag = torch.sum(torch.where(ell_cols == row, ell_data,
                                     torch.zeros_like(ell_data)), dim=1)
        s = torch.where(diag.abs() > 1e-300, 1.0 / torch.sqrt(diag.abs()),
                        torch.ones_like(diag))
        return s[:, None] * ell_data * s[ell_cols], s

    def reported_equilibrate(ell_data, ell_cols):
        data_s, s = (reference_equilibrate if jacobi else equilibrate)(
            ell_data, ell_cols)
        row = torch.arange(ell_data.shape[0])[:, None]
        diag = torch.sum(torch.where(ell_cols == row, ell_data,
                                     torch.zeros_like(ell_data)), dim=1)
        stats.update(min_diag=float(diag.abs().min()),
                     unscaled=int(((s == 1.0) & (diag.abs() != 1.0)).sum()),
                     max_entry=float(data_s.abs().max()))
        return data_s, s

    def checked_inv(M, *args):
        X = inv(M, *args)
        eye = torch.eye(M.shape[-1], dtype=M.dtype)
        errs.append(float((M @ X - eye).abs().max()))
        return X

    def reported_factor(D, L, U, *args):
        errs.clear()
        out = factor(D, L, U, *args)
        print(f"factor: min |diag| {stats['min_diag']:.2e}, rows unscaled "
              f"{stats['unscaled']}, max |entry| {stats['max_entry']:.2e}, "
              f"max |M_k X_k - I| {max(errs):.2e} (block "
              f"{int(np.argmax(errs))})", flush=True)
        return out

    blocktri._equilibrate = reported_equilibrate
    blocktri._block_inv = checked_inv
    blocktri.bt_factor = reported_factor


def main(mode: str, res: float):
    t0 = time.time()
    kw = dict(polynomial_order=1, tol_exit=1e-8, alpha_max=1e4,
              maximum_number_of_outer_loop_iterations=60, verbose=False)
    if mode in ("jax", "jax-tpu"):
        import jax
        jax.config.update("jax_platforms", "cpu")
        from proximalgalerkin_tpu.mesh.unstructured import create_disk_mesh
        from proximalgalerkin_tpu.models.obstacle import \
            solve_obstacle_problem
        kw["solver_options"] = OPTS
        if mode == "jax-tpu":
            _patch_jax_tpu_inverse()
    elif mode in ("torch", "torch-jacobi", "lu"):
        from proximalgalerkin_torch.mesh.unstructured import create_disk_mesh
        from proximalgalerkin_torch.models.obstacle import \
            solve_obstacle_problem
        kw["device"] = "cpu"
        if mode != "lu":
            kw["solver_options"] = OPTS
            _report_torch_factors(jacobi=mode == "torch-jacobi")
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    prob, r = solve_obstacle_problem(create_disk_mesh(res=res), **kw)
    print(f"{mode} res {res}: dofs {prob.space.num_dofs}, LVPP "
          f"{r.iterations}, Newton {list(r.newton_steps)}, converged "
          f"{r.converged} ({time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], float(sys.argv[2]))
