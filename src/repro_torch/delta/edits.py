"""Edge-delta descriptions for streaming graph updates (port of
``repro.delta.edits``; host numpy, the same classes and messages).

An :class:`EdgeDelta` is the user-facing batch of edits (adds, removes,
reweights) expressed over *undirected* edges by default, matching
:func:`repro_torch.core.graph.build_csr`'s ``symmetrize=True`` convention.  An
:class:`AppliedDelta` is the patcher's record of what actually changed:
the *directed* edit list with each edit classified against the old
weight (a reweight to the identical value is a no-op), which is exactly
what incremental repair needs to decide invalidation and frontier seeds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "KIND_ADD", "KIND_REMOVE", "KIND_INCREASE", "KIND_DECREASE",
    "KIND_SAME", "EdgeDelta", "AppliedDelta",
]

# directed edit kinds, recorded per edit in AppliedDelta.kind
KIND_ADD, KIND_REMOVE, KIND_INCREASE, KIND_DECREASE, KIND_SAME = range(5)


def _as_pairs(edges, what):
    arr = np.asarray(list(edges), dtype=np.int64)
    if arr.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"{what} must be (u, v) pairs; got shape "
                         f"{arr.shape}")
    return arr[:, 0].copy(), arr[:, 1].copy()


def _as_triples(edges, what):
    rows = list(edges)
    if not rows:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    arr = np.asarray(rows, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"{what} must be (u, v, w) triples; got shape "
                         f"{arr.shape}")
    u = arr[:, 0].astype(np.int64)
    v = arr[:, 1].astype(np.int64)
    if not (np.all(arr[:, 0] == u) and np.all(arr[:, 1] == v)):
        raise ValueError(f"{what} vertex ids must be integers")
    w = arr[:, 2].astype(np.float32)
    if not np.all(np.isfinite(w) & (w > 0.0)):
        raise ValueError(f"{what} weights must be positive and finite "
                         "(float32)")
    return u, v, w


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """One batch of edge edits.

    ``add``/``reweight`` are ``(u, v, w)`` triples, ``remove`` is
    ``(u, v)`` pairs.  With ``symmetrize=True`` (the default, matching
    ``build_csr``) each edit applies to both stored directions.  Weights
    are validated positive finite and held as float32 — the graph's
    native weight dtype — so an identical-value reweight is detected
    exactly.
    """
    add: tuple = ()
    remove: tuple = ()
    reweight: tuple = ()
    symmetrize: bool = True

    def __post_init__(self):
        au, av, aw = _as_triples(self.add, "add")
        ru, rv = _as_pairs(self.remove, "remove")
        wu, wv, ww = _as_triples(self.reweight, "reweight")
        object.__setattr__(self, "add", (au, av, aw))
        object.__setattr__(self, "remove", (ru, rv))
        object.__setattr__(self, "reweight", (wu, wv, ww))

    @property
    def n_edits(self) -> int:
        """Number of *undirected* edits in the batch."""
        return (self.add[0].size + self.remove[0].size
                + self.reweight[0].size)

    def __bool__(self) -> bool:
        return self.n_edits > 0


@dataclasses.dataclass(frozen=True)
class AppliedDelta:
    """Directed record of an applied delta (the patcher's receipt).

    ``(src[i], dst[i], kind[i])`` is one directed edit as it landed in
    the CSR; with ``symmetrize=True`` each undirected edit contributes
    two entries.  ``kind`` classifies reweights against the old stored
    weight, so repair can take the decrease-only fast path
    (``decrease_only``: no removals, no increases — every old shortest
    path is still valid) and serving can keep stale ALT landmarks
    (``safe_stale``: no adds, no decreases — old landmark distances stay
    admissible lower bounds).
    """
    src: np.ndarray
    dst: np.ndarray
    kind: np.ndarray

    @property
    def n_edits(self) -> int:
        """Number of *directed* edits (KIND_SAME no-ops included)."""
        return int(self.src.size)

    @property
    def decrease_only(self) -> bool:
        return not np.any((self.kind == KIND_REMOVE)
                          | (self.kind == KIND_INCREASE))

    @property
    def safe_stale(self) -> bool:
        return not np.any((self.kind == KIND_ADD)
                          | (self.kind == KIND_DECREASE))
