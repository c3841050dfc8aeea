"""proximalgalerkin_torch — the LVPP P1 obstacle solver in PyTorch, with
hand-written CUDA kernels for the fused multigrid-preconditioned CG, the
DIA sparse matrix-vector product and the fused Jacobi (DIA) CG.

The port of the JAX package beside it, which stays the reference.
Module paths mirror the reference's so that each counterpart is easy
to find:

  elements/, mesh/, spaces/, native/   host numpy setup, copied as is
  la/          ELL and DIA sparse operators on torch tensors
  ops/         lattice multigrid (mg.py) and the kernel wrappers: fused
               MG-PCG (mgfused.py, CUDA source csrc/mgfused.cu), DIA SpMV
               (dia_spmv.py) and fused DIA-CG (dia_cg.py, both in
               csrc/dia.cu); _nvcc.py builds the sources
  models/      the P1 lumped-mass obstacle solver
  cli.py       the `bench` subcommand

Nothing here imports jax. Device placement is explicit: callers pass a
`device`; a CPU tensor takes each kernel's plain PyTorch version, a CUDA
tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
