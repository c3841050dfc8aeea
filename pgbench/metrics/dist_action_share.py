"""Share of the traced solve's seconds in the distributed Jacobian
actions: the program's spans `dist.jac_action` (parallel/dofpart:
fold(jvp(core, ext(x), ext(v))); a CUDA graph replay on a card)."""

from pgbench import spans


def read(record):
    group = spans.first_solve("lvpp.solve")
    if group is None:
        return None
    return spans.share(record, spans.seconds(group, ["dist.jac_action"]))
