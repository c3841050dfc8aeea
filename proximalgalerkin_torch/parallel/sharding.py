"""Cell sharding: the counterpart of the reference package's GSPMD mode
(parallel/sharding.py).

The cells are split into n contiguous blocks along the shard axis of a
`ShardComm`; per-cell assembly arrays (quadrature geometry, gather
indices, quadrature-point coefficients) keep only the blocks this process
holds, the dof vector is replicated, and the residual is the `psum` of the
per-block scatter-adds — the reduction XLA inserts for the reference's
sharded scatter-add, and the ghostUpdate(ADD/REVERSE) of the MPI code.
The blocks of one process run batched: block b scatters into its own
copy of the dof vector (gather indices offset by b * N), and the copies
are summed over the shard axis.

Structured generators emit cells in block order, so a contiguous block
partition is also geometrically local.
"""

from __future__ import annotations

from typing import Optional

import torch

from .comm import ShardComm


def device_mesh(n_devices: Optional[int] = None, device="cuda",
                group=None) -> ShardComm:
    """A shard axis of n_devices subdomains (default: the process group's
    size, or 1) on `device`."""
    if n_devices is None:
        import torch.distributed as dist
        n_devices = dist.get_world_size(group) if group is not None else 1
    return ShardComm(n_devices, device, group)


def _local_cells(a: torch.Tensor, comm: ShardComm, cpb: int):
    """The cells of this process's blocks of a per-cell array."""
    return a[comm.lo * cpb:(comm.lo + comm.nloc) * cpb]


def shard_form(form, comm: ShardComm) -> None:
    """Split the form's per-cell arrays into comm.nd contiguous cell blocks
    and keep this process's; its residual, Jacobian action and diagonal
    then psum the blocks' scatter-adds. Requires ncells divisible by
    comm.nd (structured generators make this easy)."""
    n = comm.nd
    ncells = form.mesh.num_cells
    if ncells % n != 0:
        raise ValueError(f"ncells={ncells} not divisible by mesh size {n}")
    cpb = ncells // n
    cd = form.cell_data
    loc = lambda a: _local_cells(a, comm, cpb)
    sharded = {"xq": loc(cd["xq"]), "wdet": loc(cd["wdet"]),
               "G": loc(cd["G"]),
               "gather_idx": {k: loc(v) for k, v in cd["gather_idx"].items()},
               "coeff_idx": {k: loc(v) for k, v in cd["coeff_idx"].items()}}
    form.cell_data = sharded
    form.shard_comm = comm
    # each block scatters into its own copy of a dof vector: offsets of
    # its gather indices into the nloc stacked copies
    blk = torch.arange(comm.nloc, device=form.device).repeat_interleave(cpb)

    def offset(idx, size):
        return idx + (blk * size).reshape((-1,) + (1,) * (idx.ndim - 1))

    N = form.space.num_dofs
    stacked = dict(sharded)
    stacked["gather_idx"] = {k: offset(v, N)
                             for k, v in sharded["gather_idx"].items()}
    stacked["coeff_idx"] = {
        k: offset(v, form.coeff_spaces[k].num_dofs)
        for k, v in sharded["coeff_idx"].items()}
    residual_core = type(form)._residual_core
    diagonal_core = type(form)._diagonal_core

    def stack(coeffs):
        return {k: (form._as(v).repeat(comm.nloc) if k in form.coeff_tab
                    else v) for k, v in (coeffs or {}).items()}

    def sharded_residual(x, coeffs, consts, data=None, out_size=None,
                         fn=None):
        if data is not None:
            return residual_core(form, x, coeffs, consts, data, out_size, fn)
        F = residual_core(form, form._as(x).repeat(comm.nloc),
                          stack(coeffs), consts, stacked,
                          comm.nloc * N, fn)
        return comm.psum(F.reshape(comm.nloc, N))

    def sharded_diagonal(x, coeffs, consts, data=None, out_size=None):
        if data is not None:
            return diagonal_core(form, x, coeffs, consts, data, out_size)
        d = diagonal_core(form, form._as(x).repeat(comm.nloc),
                          stack(coeffs), consts, stacked, comm.nloc * N)
        return comm.psum(d.reshape(comm.nloc, N))

    form._residual_core = sharded_residual
    form._diagonal_core = sharded_diagonal


def shard_problem(problem, comm: ShardComm) -> None:
    """Shard a NonlinearProblem: cell arrays and quadrature-point
    coefficient arrays split into the comm's cell blocks, dof-indexed data
    (FE coefficients, Dirichlet data) replicated."""
    form = problem.form
    ncells = form.mesh.num_cells
    shard_form(form, comm)
    cpb = ncells // comm.nd
    problem.coeffs = {
        k: (v if k in form.coeff_tab else _local_cells(form._as(v), comm,
                                                       cpb))
        for k, v in problem.coeffs.items()}


def replicated(comm: ShardComm):
    """The placement of replicated (unsharded) data: the comm's device."""
    return comm.device
