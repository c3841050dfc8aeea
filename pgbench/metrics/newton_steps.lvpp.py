"""Newton steps of one general-stack solve, summed over its LVPP steps
(LVPPResult.newton_steps)."""


def read(record):
    newton = record["counts"].get("newton")
    return None if newton is None else float(sum(newton))
