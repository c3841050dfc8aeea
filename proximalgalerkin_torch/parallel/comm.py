"""The shard axis and its collectives: the counterpart of the reference
package's one-dimensional device mesh under `shard_map`.

PyTorch has no in-process SPMD mesh, so a distributed array here carries a
leading *shard axis*: row i of an (nloc, ...) tensor is subdomain
`lo + i`'s block. A `ShardComm(nd, device)` without a process group holds
all `nd` subdomains in one process on one device (the reference's
one-process mesh of nd devices); with a `torch.distributed` process group
each of the group's `world` processes holds a contiguous block of
`nd / world` shards on its own device.

The collectives of the reference map onto the shard axis:

  * `ring(x, s)` is `ppermute` with the pairs (src=(i+s) % nd, dst=i):
    shard i receives shard (i+s) mod nd. In one process it is
    `torch.roll(x, -s, dims=0)`; across processes the shards that cross a
    block edge travel by `dist.batch_isend_irecv`.
  * the reverse pairs (src=i, dst=(i+s) % nd) are `ring(x, -s)`.
  * `psum(x)` sums over the shard axis. The per-shard values are gathered
    in global shard order first (an all_gather across processes), so the
    sum's rounding is the same whether one process or several hold the
    shards.
  * `axis_index()` gives the global indices of the local shards.

Backend: NCCL for CUDA tensors, one card per process; gloo for CPU
tensors. Two NCCL ranks on one card are refused by NCCL, so on a one-card
machine every subdomain lives in one process.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


class ShardComm:
    """nd subdomains along the shard axis, on `device`; `group` a
    torch.distributed process group (None: one process holds them all)."""

    def __init__(self, nd: int, device, group=None):
        self.nd = int(nd)
        self.device = torch.device(device)
        self.group = group
        if group is None:
            self.world, self.rank = 1, 0
        else:
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        if self.nd % self.world:
            raise ValueError(f"{self.nd} subdomains do not split evenly over "
                             f"{self.world} processes")
        self.nloc = self.nd // self.world
        self.lo = self.rank * self.nloc
        self._plans = {}

    @property
    def local(self) -> slice:
        """The global shard indices this process holds."""
        return slice(self.lo, self.lo + self.nloc)

    def axis_index(self) -> torch.Tensor:
        return torch.arange(self.lo, self.lo + self.nloc,
                            device=self.device)

    # ------------------------------------------------------------ ring

    def _plan(self, s: int):
        """For a ring shift s across processes: per peer rank, the local
        positions this process receives into and the local positions it
        sends from, both in the order of the destination's shard index."""
        if s in self._plans:
            return self._plans[s]
        nd, nloc = self.nd, self.nloc
        recv, send = {}, {}
        for q in range(self.world):
            # I receive out[a] = x_global[(lo + a + s) % nd] from owner q
            src = (self.lo + np.arange(nloc) + s) % nd
            a = np.flatnonzero(src // nloc == q)
            if len(a):
                recv[q] = (a, src[a] - q * nloc)
            # I send to rank q the shards b whose destination
            # (lo + b - s) % nd lies in q's block, in destination order
            dst = (self.lo + np.arange(nloc) - s) % nd
            b = np.flatnonzero(dst // nloc == q)
            if len(b):
                send[q] = b[np.argsort(dst[b])]
        self._plans[s] = (recv, send)
        return recv, send

    def ring(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """Shard i of the result is shard (i + s) mod nd of x."""
        s %= self.nd
        if s == 0:
            return x
        if self.world == 1:
            return torch.roll(x, -s, dims=0)
        recv, send = self._plan(s)
        out = torch.empty_like(x)
        ops, bufs = [], []
        for q, b in send.items():
            if q == self.rank:
                continue
            idx = torch.as_tensor(b, device=x.device)
            ops.append(dist.P2POp(dist.isend, x[idx].contiguous(),
                                  self._global_rank(q), self.group))
        for q, (a, src) in recv.items():
            if q == self.rank:
                ia = torch.as_tensor(a, device=x.device)
                out[ia] = x[torch.as_tensor(src, device=x.device)]
                continue
            buf = torch.empty((len(a),) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            ops.append(dist.P2POp(dist.irecv, buf, self._global_rank(q),
                                  self.group))
            bufs.append((a, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for a, buf in bufs:
            out[torch.as_tensor(a, device=x.device)] = buf
        return out

    def _global_rank(self, q: int) -> int:
        return dist.get_global_rank(self.group, q) \
            if self.group is not dist.GroupMember.WORLD else q

    # ------------------------------------------------------ reductions

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """(nloc, ...) -> (nd, ...) in global shard order, on every
        process (an all_gather over the group, even a group of one)."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the shard axis (dim 0) of every shard, in global
        shard order."""
        return self.gather_shards(x).sum(0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather_shards(x).amax(0)


def world_comm(nd: int, device, group: Optional[object] = None
               ) -> ShardComm:
    """nd subdomains over the processes of `group` (default the world
    group of an initialised torch.distributed)."""
    return ShardComm(nd, device, group or dist.GroupMember.WORLD)
