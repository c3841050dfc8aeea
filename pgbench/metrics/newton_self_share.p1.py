"""Share of the traced solve's seconds in the P1 outer loop and Newton
step themselves: the self time of the program's spans `p1.solve` and
`p1.newton_step` (the f64 residuals, Schur right-hand sides, refinement
matvecs and their host reads), the inner solves left out."""

from pgbench import spans


def read(record):
    group = spans.first_solve("p1.solve")
    if group is None:
        return None
    return spans.share(record, spans.self_seconds(
        group, ["p1.solve", "p1.newton_step"]))
