"""Distribution over subdomains on a shard axis (comm.py): cell sharding
(sharding.py), the halo-exchange FD solver (halo.py), the dof-partitioned
FEM (dofpart.py) and multi-process start-up (multihost.py)."""

from .comm import ShardComm
from .sharding import device_mesh, replicated, shard_form, shard_problem

__all__ = ["ShardComm", "device_mesh", "shard_form", "shard_problem",
           "replicated"]
