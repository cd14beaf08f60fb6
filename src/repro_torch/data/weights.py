"""Edge-weight variants (paper §4.2, Eqs. 7-8), the port's copy of
``repro.data.weights`` over the port's :func:`~repro_torch.core.graph.
build_csr`; the same graph and arguments give the reference's
``HostGraph``, every field bitwise.

    discretize(x, power) = 1 + x * (2^power - 2)        (integerized)
    converge(x, pivot)   = bell curve peaked at `pivot`; half the mass
                           below the pivot.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import HostGraph, build_csr


def discretize(w: np.ndarray, power: int) -> np.ndarray:
    """Map (0,1] weights to {1, ..., 2^power - 1} (Eq. 7)."""
    return np.floor(1 + w * (2 ** power - 2)).astype(np.float64)


def converge(w: np.ndarray, pivot: float) -> np.ndarray:
    """Bell-curve remap peaked at `pivot` (Eq. 8)."""
    lo = pivot - pivot * (1 - 2 * w) ** 2
    hi = pivot + (1 - pivot) * (1 - 2 * w) ** 2
    return np.where(w <= 0.5, lo, hi)


def make_variant(g: HostGraph, power: int | None = None,
                 pivot: float | None = None) -> HostGraph:
    """Create a variant graph by remapping edge weights (paper §4.2)."""
    if (power is None) == (pivot is None):
        raise ValueError("exactly one of power/pivot")
    # the undirected edge list: one slot of each symmetric pair
    mask = g.src < g.dst
    u, v, w = g.src[mask], g.dst[mask], g.w[mask].astype(np.float64)
    w2 = discretize(w, power) if power is not None else converge(w, pivot)
    return build_csr(g.n, u, v, w2)
