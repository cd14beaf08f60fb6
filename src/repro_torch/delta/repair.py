"""Incremental SSSP repair after an edge delta (port of
``repro.delta.repair``).

The repaired state is *bitwise-identical* to a from-scratch solve on
the patched graph.  Why this holds: the engines' relaxation is a
monotone fixpoint iteration — from any valid upper-bound state (every
finite tentative dist is the rounded float32 length of some real path,
and the true fixpoint is everywhere ≤ the tentative value), re-relaxing
to fixpoint yields ``min`` over all paths of the rounded left-fold sum,
independent of schedule.  Repair constructs exactly such a state:

- **decrease-only deltas** (adds + weight decreases): every old
  shortest path still exists, so the old dist/parent are already a
  valid upper bound; the frontier re-seeds from the edited edges'
  sources and only improvements propagate.
- **removals / increases**: old entries that routed through an edited
  edge may be *under*-estimates.  Every vertex whose tree parent edge
  was removed/increased is invalidated, the invalidation propagates to
  the whole downstream subtree (pointer jumping over parent chains),
  and invalid entries reset to ``(+inf, -1)`` — the remaining finite
  entries are exact, hence a valid upper bound.  The frontier re-seeds
  from the (new-graph) in-neighbors of the invalid region plus the
  gain-edit sources.  Removing or increasing a non-tree edge
  (``parent[v] != u``) invalidates nothing: it is a provable no-op.

Parent bitwise parity additionally relies on the argmin winner being
unique (no exact float32 path-length ties), which holds for
generic random weights; both sides use the same relaxation primitives
and edge order, so tie-breaks coincide wherever ties do occur in the
same round pattern.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import graph, sssp
from .edits import AppliedDelta, KIND_ADD, KIND_DECREASE, KIND_INCREASE, \
    KIND_REMOVE

__all__ = ["RepairStats", "repair_state", "repair"]


@dataclasses.dataclass(frozen=True)
class RepairStats:
    """Host-side accounting for one repair (the blast radius)."""
    n_invalid: int      # vertices whose old dist/parent were reset
    n_seeds: int        # vertices in the re-seeded frontier
    fast_path: bool     # decrease-only delta: invalidation skipped


def repair_state(new_host: graph.HostGraph, dist, parent,
                 applied: AppliedDelta):
    """Invalidate + re-seed; returns ``(dist, parent, frontier, stats)``.

    ``dist``/``parent`` are the pre-delta solve state (length ``n`` or
    padded; extra entries are ignored; tensors are copied to the host).
    The returned numpy arrays are the valid upper-bound state and seed
    frontier to feed :func:`repro_torch.core.sssp.repair_relax` or
    :func:`repro_torch.core.distributed.repair_distributed`, equal to
    the reference's array for array.
    """
    n = new_host.n
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else a
    dist = np.asarray(host(dist), np.float32)[:n]
    parent = np.asarray(host(parent), np.int32)[:n]
    fast = bool(applied.decrease_only)

    invalid = np.zeros(n, bool)
    if not fast:
        sel = (applied.kind == KIND_REMOVE) | (applied.kind == KIND_INCREASE)
        vv, uu = applied.dst[sel], applied.src[sel]
        hit = (parent[vv] == uu) & (vv != uu)   # self-parent = the source
        invalid[vv[hit]] = True
        if invalid.any():
            # propagate down the tree by pointer jumping: O(m log n) worst
            # case but O(n) per sweep, and sweeps stop mattering once every
            # chain is covered
            anc = np.where(parent >= 0, parent, np.arange(n))
            for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
                invalid |= invalid[anc]
                anc = anc[anc]

    dist_i = np.where(invalid, np.float32(np.inf), dist)
    parent_i = np.where(invalid, np.int32(-1), parent)

    seed = np.zeros(n, bool)
    if invalid.any():
        # in-neighbors of the invalid region, over the NEW graph
        seed[np.asarray(new_host.src)[invalid[np.asarray(new_host.dst)]]] \
            = True
    gain = (applied.kind == KIND_ADD) | (applied.kind == KIND_DECREASE)
    seed[applied.src[gain]] = True
    frontier = seed & ~invalid & np.isfinite(dist_i)
    return dist_i, parent_i, frontier, RepairStats(
        n_invalid=int(invalid.sum()), n_seeds=int(frontier.sum()),
        fast_path=fast)


def repair(layout, new_host: graph.HostGraph, dist, parent,
           applied: AppliedDelta, *, backend: str = "segment_min",
           fused_rounds: int = 0, max_iters: int = 1_000_000):
    """Repair a single-device solve state against a patched layout.

    ``layout`` must already be the *patched* layout for ``backend``
    (from :mod:`repro_torch.delta.patch` or a fresh ``prepare_layout`` on
    ``new_host``); the repaired state moves to its device.  Returns
    ``(dist, parent, metrics, stats)`` with dist/parent bitwise-identical
    to a from-scratch solve and metrics counting only the repair's own
    relaxation work.  For the sharded v1 engine, pair
    :func:`repair_state` with
    :func:`repro_torch.core.distributed.repair_distributed`.
    """
    dist_i, parent_i, frontier, stats = repair_state(new_host, dist,
                                                     parent, applied)
    dev = layout.w.device
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    d2, p2, metrics = sssp.repair_relax(
        layout, put(dist_i), put(parent_i), put(frontier), backend=backend,
        max_iters=max_iters, fused_rounds=fused_rounds)
    return d2, p2, metrics, stats
