"""Share of the traced solve's window in which no operation ran on the
device: 1 - (union of device intervals) / window."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
