"""Refinement corrections of the block-tridiagonal direction in one
solve: the program's counter `bt.refine_passes` over the spans of the
root `lvpp.solve`."""

from pgbench import spans


def read(record):
    group = spans.first_solve("lvpp.solve")
    if group is None or not any(s.name == "bt.apply" for s in group):
        return None
    return float(spans.counted(group, "bt.refine_passes"))
