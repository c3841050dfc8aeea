"""proximalgalerkin_torch — the LVPP finite-element framework in PyTorch,
with hand-written CUDA kernels for the P1 obstacle fast path (the fused
multigrid-preconditioned CG, the DIA sparse matrix-vector product and the
fused Jacobi (DIA) CG).

The port of the JAX package beside it, which stays the reference.
Module paths and public names mirror the reference's so that each
counterpart is easy to find:

  core/        options (SolverOptions), SNES reasons, monitors, the span
               and counter recorder (span, count, tracing; PhaseTimer)
  elements/, mesh/, spaces/, native/, io/   host numpy setup, copied as is
               (mesh/unstructured.py: the disk meshes; manifolds.py: the
               Möbius strip; parametric.py: the ball and half-disk /
               half-sphere specimens; io/vtu.py: output)
  forms/       the constraint-to-latent maps (exp, softmax, expm2, tanhm...)
  assembly/    VolumeForm: residual, jvp Jacobian action, jacfwd element
               matrices and diagonal, functionals (torch.func)
  la/          ELL and DIA operators, Krylov solvers (krylov.py) on
               device-side loops (loop.py), host SuperLU (direct.py),
               nested-dissection ordering (ordering.py), the device
               block-tridiagonal direct solver (blocktri.py, pc_type
               'btlu') and the block-Schur preconditioners (schur.py,
               pc_type 'schur'/'schur_mg', on the lattice multigrid of
               gmg.py)
  solve/       NonlinearProblem, NewtonSolver (SNES semantics), LVPPSolver
  ops/         lattice multigrid (mg.py) and the kernel wrappers: fused
               MG-PCG (mgfused.py, CUDA source csrc/mgfused.cu), DIA SpMV
               (dia_spmv.py) and fused DIA-CG (dia_cg.py, both in
               csrc/dia.cu); _nvcc.py builds the sources
  models/      the obstacle problem (obstacle.py, the general stack), its
               P1 lumped-mass fast path (obstacle_p1.py), its FD and
               spectral variants (obstacle_fd.py, obstacle_spectral.py),
               and the example models on the general stack
               (intersecting, eigenvalue_constraints, thermoforming and
               thermoforming_compare, gradient_constraint, fracture,
               multiphase, eikonal, monge_ampere)
  utils/       LVPP checkpoints (the reference's file format), point
               evaluation (pointeval.py)
  cli.py       the `obstacle`, `obstacle-fd`, model and `bench`
               subcommands

Nothing here imports jax. Device placement is explicit: callers pass a
`device` (entry points default to the card); a CPU tensor takes each
kernel's plain PyTorch version, a CUDA tensor launches the kernel or
raises.
"""

__version__ = "0.1.0"
