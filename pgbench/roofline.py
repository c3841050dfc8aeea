"""Frozen yardstick: the published peak, the compulsory bytes of the
port's hand-written kernels, and the busy-share arithmetic.

Copies of chip_smoke.py's `PEAK_BYTES_PER_S`, `mg_iteration_bytes`,
`fd_iteration_bytes`, the K1/K2 row bytes and `busy_profile`'s union of
device intervals, kept here so that the program cannot move the
yardstick. Bytes count each input read once and each output written
once; a roofline share is that least time over the measured device
time.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

# one H100 SXM's device memory rate (NVIDIA data sheet, at 700 W)
PEAK_BYTES_PER_S = 3.35e12

# the f32 DIA-CG kernels of csrc/dia.cu per row of the folded 5-point
# operator: K1 reads 5 diagonals, r, p and writes q and its partial
# dot (44 B); K2 reads x, r, p, q and writes x, r (24 B, counted as in
# chip_smoke.py's bound)
K1_ROW_BYTES = 44
K2_ROW_BYTES = 24


def mg_levels(m: int) -> List[int]:
    """Grid widths of the lattice V-cycle hierarchy (ops/mg._levels_for)."""
    ms = [m]
    while ms[-1] >= 9 and (ms[-1] - 1) % 2 == 0:
        ms.append((ms[-1] - 1) // 2 + 1)
    return ms


def mg_iteration_bytes(m: int) -> int:
    """Bytes one f32 MG-PCG iteration must move at width m: B, C, x, r,
    p and every level's diagonal read once; x, r, p and xb written
    once."""
    return 4 * (9 * m * m + sum(k * k for k in mg_levels(m)))


def dia_cg_iteration_bytes(m: int) -> int:
    """Bytes of one f32 DIA-CG iteration (K1 + K2) on m * m rows."""
    return (K1_ROW_BYTES + K2_ROW_BYTES) * m * m


def fd_iteration_bytes(N: int) -> int:
    """Bytes one f64 FD Schur-CG iteration must move on the N x N grid:
    x, r and p read and written, the scaling and the latent diagonal
    read, the 1-byte free mask read."""
    return N * N * (6 * 8 + 2 * 8 + 1)


def least_seconds(nbytes: float) -> float:
    """The least time the chip could take to move nbytes."""
    return nbytes / PEAK_BYTES_PER_S


def union_seconds(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals (busy time)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy
