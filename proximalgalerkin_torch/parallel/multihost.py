"""Multi-process start-up on torch.distributed: the counterpart of the
reference package's `jax.distributed` wiring (parallel/multihost.py).

One process per card (or per CPU worker), joined by
`torch.distributed.init_process_group`; a `ShardComm` over the world group
then runs the same dof-partitioned code as the one-process shard axis,
with NCCL carrying the exchanges between cards and gloo between CPU
processes. The arguments default to torchrun's standard environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK); explicit
arguments override it.

NCCL refuses two ranks on one card, so a CUDA process group needs one
card per process: on a one-card machine run the subdomains along the
shard axis of one process instead.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: str = "cuda",
                   backend: Optional[str] = None) -> tuple:
    """Join the process group. coordinator_address 'host:port' (default
    MASTER_ADDR:MASTER_PORT), num_processes (WORLD_SIZE), process_id
    (RANK); device 'cuda' (default: the card LOCAL_RANK, else the process
    id; no card raises) or 'cpu' when the caller asks for it; backend
    'nccl' for cuda, 'gloo' for cpu unless given. A backend that fails to
    start raises: nothing falls back to another backend or device.

    Returns (process_index, process_count, devices): `devices` holds this
    process's one device."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
                               if "MASTER_ADDR" in env else None)
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_multihost needs the coordinator address, "
                         "the process count and the process id (arguments "
                         "or MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK)")
    if device == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    return dist.get_rank(), dist.get_world_size(), [dev]


def is_coordinator() -> bool:
    """Rank 0 of the process group (or the only process): where IO and
    printing happen, as the reference's rank-0 guards."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def shutdown():
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
