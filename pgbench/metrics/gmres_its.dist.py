"""Arnoldi steps of the distributed GMRES in one solve: the program's
counter `dist.gmres_its` summed over the spans of the root
`lvpp.solve`."""

from pgbench import spans


def read(record):
    group = spans.first_solve("lvpp.solve")
    if group is None or not any(s.name == "dist.gmres" for s in group):
        return None
    return float(spans.counted(group, "dist.gmres_its"))
