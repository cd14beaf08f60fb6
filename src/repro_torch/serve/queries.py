"""Answers of p2p queries (port of ``repro.serve.queries``; only the path
reconstruction is ported so far)."""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["reconstruct_path"]


def reconstruct_path(parent, source: int, target: int) -> Optional[list]:
    """Walk the parent array target -> source; None if unreachable."""
    parent = np.asarray(parent)
    if target == source:
        return [source]
    path = [target]
    v = target
    # parent chains are cycle-free by construction; the bound is a guard
    for _ in range(parent.shape[0]):
        v = int(parent[v])
        if v < 0:
            return None
        path.append(v)
        if v == source:
            return path[::-1]
    return None
