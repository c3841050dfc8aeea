"""Share of the traced solve's seconds in the host direct solve and its
hand-off: PhaseTimer host_transfer + csr + lu_factor + lu_solve, which
do not nest in one another."""


def read(record):
    ph, secs = record.get("phases"), record.get("solve_s")
    if not ph or not secs or ph.get("lu_factor", 0.0) <= 0:
        return None
    t = sum(ph.get(k, 0.0) for k in ("host_transfer", "csr", "lu_factor",
                                     "lu_solve"))
    return 100.0 * t / secs
