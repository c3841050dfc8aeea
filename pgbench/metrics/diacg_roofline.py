"""Share of their roofline that the f32 DIA-CG kernels K1 + K2
(ops/dia_cg, csrc/dia.cu k_k1, k_k2) reach over a traced solve: CG
iterations times their row bytes (44 + 24) over m * m rows at the
published peak rate, over the profiler's device time of both."""

import re

from pgbench import roofline

KERNELS = re.compile(r"\bk_k[12]\b")


def read(record):
    trace, cg = record.get("trace"), record["extra"].get("cg")
    if not trace or not cg:
        return None
    secs = sum(s for name, (s, _) in trace["kernels"].items()
               if KERNELS.search(name))
    if secs <= 0:
        return None
    m = record["config"]["n"] + 1
    least = roofline.least_seconds(cg * roofline.dia_cg_iteration_bytes(m))
    return 100.0 * least / secs
