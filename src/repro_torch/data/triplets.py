"""Triplet indices for directional GNNs (DimeNet), the port's copy of
the reference's ``repro.data.triplets``.

For every directed edge e2 = (j -> i) the in-edges e1 = (k -> j) with
k != i, at most ``cap`` of them per edge (a seeded draw without
replacement where there are more), padded to ``e * cap`` slots with a
mask, so that the shapes are static.  Numpy: this is data preparation,
not device work.  The same seed gives the reference's arrays.
"""
from __future__ import annotations

import numpy as np


def build_triplets(senders: np.ndarray, receivers: np.ndarray, cap: int = 8,
                   seed: int = 0):
    """``(t_kj, t_ji, mask)``: int32 edge indices into the edge list and
    the bool mask of the real slots, each ``[e * cap]``."""
    e = senders.shape[0]
    rng = np.random.default_rng(seed)
    order = np.argsort(receivers, kind="stable")   # in-edges grouped by head
    rec_sorted = receivers[order]
    starts = np.searchsorted(rec_sorted, np.arange(0, receivers.max() + 2
                                                   if e else 1))
    t_kj, t_ji = [], []
    for e2 in range(e):
        j = senders[e2]
        i = receivers[e2]
        if j + 1 >= len(starts):
            continue
        in_edges = order[starts[j]:starts[j + 1]]
        in_edges = in_edges[senders[in_edges] != i]
        if in_edges.shape[0] > cap:
            in_edges = rng.choice(in_edges, cap, replace=False)
        t_kj.append(in_edges)
        t_ji.append(np.full(in_edges.shape[0], e2, np.int64))
    if t_kj:
        t_kj = np.concatenate(t_kj)
        t_ji = np.concatenate(t_ji)
    else:
        t_kj = np.zeros(0, np.int64)
        t_ji = np.zeros(0, np.int64)
    t_max = e * cap
    mask = np.zeros(t_max, bool)
    mask[:t_kj.shape[0]] = True
    pad = t_max - t_kj.shape[0]
    t_kj = np.concatenate([t_kj, np.zeros(pad, np.int64)])
    t_ji = np.concatenate([t_ji, np.zeros(pad, np.int64)])
    return t_kj.astype(np.int32), t_ji.astype(np.int32), mask
