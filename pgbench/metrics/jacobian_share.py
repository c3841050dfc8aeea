"""Share of the traced solve's seconds in the Jacobian assembly: the
element matrices (torch.func) and their scatter, timed by the Newton
solver's PhaseTimer as `bt_assemble` on the btlu direction
(NonlinearProblem.ell_data) and as `assembly` on the host-LU one."""


def read(record):
    ph, secs = record.get("phases"), record.get("solve_s")
    if not ph or not secs:
        return None
    t = ph.get("bt_assemble", 0.0) + ph.get("assembly", 0.0)
    return 100.0 * t / secs if t > 0 else None
