"""Inner CG iterations of one fast-path solve (cg_its_total)."""


def read(record):
    cg = record["extra"].get("cg")
    return None if cg is None else float(cg)
