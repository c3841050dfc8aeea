"""Seconds per converged solve: the timed window (first solve's start
to last solve's end, host clock, each solve ending in a device-to-host
copy) over the converged solves with the first solve's counts."""


def read(record):
    if "window_s" not in record or not record.get("solves_ok"):
        return None
    return record["window_s"] / record["solves_ok"]
