"""Device-side while loops: the counterpart of jax.lax.while_loop.

A loop whose condition lives on the device would cost one device-to-host
read per iteration if it were a plain Python `while`. `while_loop` runs
the body in chunks of `chunk` iterations instead: inside a chunk, an
iteration whose condition is already false leaves the state as it was
(a device-side select), and the host reads the condition once per chunk.
The iteration count and the iterates are those of the unchunked loop;
a loop that ends inside a chunk costs at most chunk - 1 masked
iterations.

chunk = 1 is the plain loop (one read per iteration); callers whose body
is itself a chunked loop (a refinement pass around a Krylov solve, a
Newton step) use it, since a masked pass would still run its inner solve.

Each condition read counts one `host_reads` (core/logging.count), so
tests and the benchmark can see how often a solve waited on the host.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.logging import count

CHUNK = 64


def _select(live: torch.Tensor, new, old):
    if isinstance(new, (tuple, list)):
        return type(new)(_select(live, n, o) for n, o in zip(new, old))
    return torch.where(live, new, old)


def while_loop(cond: Callable, body: Callable, state, chunk: int = CHUNK):
    """Run `state = body(state)` while `cond(state)` (a 0-dim bool tensor)
    holds; `state` is a tuple of tensors (nested tuples allowed)."""
    if chunk <= 1:
        while True:
            count("host_reads")
            if not bool(cond(state)):
                return state
            state = body(state)
    while True:
        for _ in range(chunk):
            state = _select(cond(state), body(state), state)
        count("host_reads")
        if not bool(cond(state)):
            return state

