"""Share of the traced solve's seconds in the block-tridiagonal factor's
applies: the program's spans `bt.apply` (la/blocktri.refine's triangular
solves, the residual SpMV between them left out)."""

from pgbench import spans


def read(record):
    group = spans.first_solve("lvpp.solve")
    if group is None:
        return None
    return spans.share(record, spans.seconds(group, ["bt.apply"]))
