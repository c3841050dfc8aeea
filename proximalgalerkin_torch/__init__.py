"""proximalgalerkin_torch — the LVPP P1 obstacle solver in PyTorch, with a
hand-written CUDA kernel for the fused multigrid-preconditioned CG.

The port of the JAX package beside it, which stays the reference.
Module paths mirror the reference's so that each counterpart is easy
to find:

  elements/, mesh/, spaces/, native/   host numpy setup, copied as is
  la/          ELL and DIA sparse operators on torch tensors
  ops/         lattice multigrid (mg.py) and the fused MG-PCG kernel
               wrapper (mgfused.py, CUDA source in csrc/mgfused.cu)
  models/      the P1 lumped-mass obstacle solver
  cli.py       the `bench` subcommand

Nothing here imports jax. Device placement is explicit: callers pass a
`device`; a CPU tensor takes each kernel's plain PyTorch version, a CUDA
tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
