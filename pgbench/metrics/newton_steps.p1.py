"""Newton steps of one fast-path solve, summed over its outer steps
(P1ObstacleResult.newton_per_outer)."""


def read(record):
    newton = record["counts"].get("newton")
    return None if newton is None else float(sum(newton))
