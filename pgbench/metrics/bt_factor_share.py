"""Share of the traced solve's seconds in the block-tridiagonal factor
(la/blocktri: block scatter, equilibration, dependent block inverses),
PhaseTimer `bt_factor`."""


def read(record):
    ph, secs = record.get("phases"), record.get("solve_s")
    if not ph or not secs or ph.get("bt_factor", 0.0) <= 0:
        return None
    return 100.0 * ph["bt_factor"] / secs
