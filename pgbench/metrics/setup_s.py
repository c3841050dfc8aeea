"""setup_s: seconds from the start of the run to the end of warm-up
(imports, kernel build, mesh, solver set-up, warm-up), host clock."""


def read(record):
    return record["setup_s"]
