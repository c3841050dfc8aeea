"""Share of the traced solve's seconds in the restricted additive
Schwarz applies: the program's spans `dist.asm_apply` (parallel/dofpart:
ghost gather, the batched block-tridiagonal solve, owned restriction;
a CUDA graph replay on a card)."""

from pgbench import spans


def read(record):
    group = spans.first_solve("lvpp.solve")
    if group is None:
        return None
    return spans.share(record, spans.seconds(group, ["dist.asm_apply"]))
