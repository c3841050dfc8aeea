"""The obstacle of Example 01 (the mixed LVPP model itself is not ported
yet; the P1 fast path in obstacle_p1.py needs only the obstacle)."""

from __future__ import annotations

import numpy as np


def spherical_cap_obstacle(x: np.ndarray) -> np.ndarray:
    """The reference's obstacle: a spherical cap of radius r0 = 0.5 blended
    into its tangent cone (obstacle_pg.py:92-104; same formula in the FD
    oracle obstacle_finite_difference.jl:13-27). x has shape (gdim, npts)."""
    r = np.sqrt(x[0] ** 2 + x[1] ** 2)
    r0, beta = 0.5, 0.9
    b = r0 * beta
    tmp = np.sqrt(r0**2 - b**2)
    B = tmp + b * b / tmp
    C = -b / tmp
    outside = B + r * C
    inside = np.sqrt(np.maximum(r0**2 - np.minimum(r, r0) ** 2, 0.0))
    return np.where(r > b, outside, inside)
