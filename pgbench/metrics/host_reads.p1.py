"""Blocking device-to-host reads of one fast-path solve: the program's
counter `host_reads` summed over the spans of the root `p1.solve` (each
Newton step's residual norm and refinement decisions, each Krylov
chunk, each increment, the answer's two copies)."""

from pgbench import spans


def read(record):
    group = spans.first_solve("p1.solve")
    return None if group is None else float(spans.counted(group,
                                                          "host_reads"))
