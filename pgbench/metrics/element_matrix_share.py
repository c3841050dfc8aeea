"""Share of the traced solve's seconds in the element matrices: the
program's span `element_matrices` (VolumeForm's torch.func Jacobian),
the same work on the btlu and the LU direction, its scatter left out."""

from pgbench import spans


def read(record):
    group = spans.first_solve("lvpp.solve")
    if group is None:
        return None
    return spans.share(record, spans.seconds(group, ["element_matrices"]))
