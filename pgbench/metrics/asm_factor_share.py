"""Share of the traced solve's seconds in the distributed Schwarz
factor: the program's spans `dist.asm_factor` (parallel/dofpart: a
Newton step's subdomain element matrices, block scatter, batched
block-tridiagonal factor and the apply's graph capture)."""

from pgbench import spans


def read(record):
    group = spans.first_solve("lvpp.solve")
    if group is None:
        return None
    return spans.share(record, spans.seconds(group, ["dist.asm_factor"]))
