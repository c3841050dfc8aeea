"""Share of the traced solve's seconds in the LVPP and Newton loops
themselves: the self time of the program's spans `lvpp.solve`,
`lvpp.step` and `newton.solve` (alpha updates, convergence tests,
observables, the Python between phases)."""

from pgbench import spans


def read(record):
    group = spans.first_solve("lvpp.solve")
    if group is None:
        return None
    return spans.share(record, spans.self_seconds(
        group, ["lvpp.solve", "lvpp.step", "newton.solve"]))
