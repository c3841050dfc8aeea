"""Blocking device-to-host reads of one general-stack solve: the
program's counter `host_reads` summed over the spans of the root
`lvpp.solve` (Newton's norms, the btlu refinement's passes, LVPP's
increment and observables, the LU direction's copies)."""

from pgbench import spans


def read(record):
    group = spans.first_solve("lvpp.solve")
    return None if group is None else float(spans.counted(group,
                                                          "host_reads"))
