"""Share of its roofline that the fused MG-PCG kernel (ops/mgfused,
csrc/mgfused.cu) reaches over a traced solve: CG iterations times the
bytes one iteration must move at the grid's width, at the published
peak rate, over the profiler's device time of the kernel's launches."""

import re

from pgbench import roofline

KERNELS = re.compile(r"\bk_(matvec|down0|down|up0|up|axpy0|rz0|sweep|"
                     r"flush|zout|tail)\b")


def read(record):
    trace, cg = record.get("trace"), record["extra"].get("cg")
    if not trace or not cg:
        return None
    secs = sum(s for name, (s, _) in trace["kernels"].items()
               if KERNELS.search(name))
    if secs <= 0:
        return None
    m = record["config"]["n"] + 1
    least = roofline.least_seconds(cg * roofline.mg_iteration_bytes(m))
    return 100.0 * least / secs
