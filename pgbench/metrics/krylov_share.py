"""Share of the traced solve's seconds in the inner Krylov solves: the
program's spans `p1.inner_solve` (ops/mgfused or ops/dia_cg, the first
solve of each Newton step and each refinement correction)."""

from pgbench import spans


def read(record):
    group = spans.first_solve("p1.solve")
    if group is None:
        return None
    return spans.share(record, spans.seconds(group, ["p1.inner_solve"]))
