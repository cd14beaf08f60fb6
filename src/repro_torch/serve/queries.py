"""Query planner: typed shortest-path queries and their result shaping
(port of ``repro.serve.queries``).

A :class:`Query` names a registered graph (``gid``), a source, and one of
the engine's query kinds (:data:`repro_torch.core.sssp.GOALS`):

* ``tree``    — full shortest-path tree;
* ``p2p``     — point-to-point distance + path to ``target``;
* ``bounded`` — every vertex within distance ``bound``;
* ``knear``   — the ``k`` nearest vertices.

:func:`plan` maps a query onto the engine's early-exit goal (kind +
parameter); queries whose plans share a :attr:`ExecutionPlan.key` can
ride in one batched solve.  :func:`finalize` shapes one engine
``(dist, parent, metrics)`` slot (torch tensors or numpy) into a
:class:`QueryResult` of numpy arrays, enforcing each kind's contract
(masking tentative entries, extracting the k-nearest list,
reconstructing the p2p path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..core.sssp import GOALS, normalized_metrics

__all__ = ["Query", "QueryResult", "ExecutionPlan", "plan", "finalize",
           "reconstruct_path"]


@dataclasses.dataclass(frozen=True)
class Query:
    """One shortest-path query against a registered graph."""
    gid: str
    source: int
    kind: str = "tree"
    target: Optional[int] = None      # p2p
    bound: Optional[float] = None     # bounded
    k: Optional[int] = None           # knear

    def __post_init__(self):
        if self.kind not in GOALS:
            raise ValueError(f"unknown query kind {self.kind!r}; "
                             f"expected one of {GOALS}")
        need = {"tree": None, "p2p": "target", "bounded": "bound",
                "knear": "k"}[self.kind]
        if need is not None and getattr(self, need) is None:
            raise ValueError(f"{self.kind!r} query requires {need}")
        # graph-size bounds are checked at execution time (the query does
        # not know its graph); sign errors are catchable right here
        if self.source < 0 or (self.target is not None and self.target < 0):
            raise ValueError("vertex ids must be non-negative")
        if self.k is not None and self.k < 1:
            raise ValueError("k must be >= 1")
        if self.bound is not None and self.bound < 0:
            raise ValueError("bound must be >= 0")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """How the engine runs a query: goal kind + per-slot parameter.

    ``key`` is the batching compatibility key: queries whose plans share
    it can ride in one batched solve (same graph, same goal)."""
    gid: str
    goal: str
    goal_param: float | int

    @property
    def key(self) -> Tuple[str, str]:
        return (self.gid, self.goal)


def plan(q: Query) -> ExecutionPlan:
    """Map a query onto the engine goal that answers it earliest."""
    param = {"tree": 0, "p2p": q.target, "bounded": q.bound,
             "knear": q.k}[q.kind]
    return ExecutionPlan(gid=q.gid, goal=q.kind, goal_param=param)


@dataclasses.dataclass
class QueryResult:
    """A finalized query answer (numpy, host-side)."""
    query: Query
    dist: np.ndarray                  # [N] f32; +inf where not settled
    parent: np.ndarray                # [N] i32; -1 where not settled
    metrics: dict                     # normalized paper metrics
    distance: Optional[float] = None  # p2p: dist[target] (inf = no path)
    path: Optional[list] = None       # p2p: source..target vertex ids
    nearest: Optional[list] = None    # knear: [(vertex, dist)] ascending
    latency_s: Optional[float] = None  # filled by a scheduler
    served_by: Optional[str] = None   # scheduler name (router placement)


def _host(a) -> np.ndarray:
    """A torch tensor (on any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def reconstruct_path(parent, source: int, target: int) -> Optional[list]:
    """Walk the parent array target -> source; None if unreachable."""
    parent = _host(parent)
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


def finalize(q: Query, deg, dist, parent, raw_metrics) -> QueryResult:
    """Shape one engine result slot into the query's answer contract.

    Early-exit runs return tentative (upper-bound) distances for vertices
    the goal did not require settling; each kind masks or extracts
    accordingly so callers never observe a non-final value.  ``deg``,
    ``dist`` and ``parent`` may be torch tensors or numpy arrays;
    ``raw_metrics`` an ``SsspMetrics`` of either.  Returns numpy.
    """
    dist = _host(dist)
    parent = _host(parent)
    metrics = normalized_metrics(_host(deg), dist, raw_metrics)
    res = QueryResult(query=q, dist=dist, parent=parent, metrics=metrics)
    if q.kind == "p2p":
        res.distance = float(dist[q.target])
        res.path = reconstruct_path(parent, q.source, q.target)
        if int(_host(getattr(raw_metrics, "n_pruned", 0))) > 0:
            # ALT-pruned run: only dist[target] and its parent chain are
            # guaranteed (an off-path vertex's last improvement may have
            # been pruned); keep exactly the reconstructed path
            keep = np.zeros(dist.shape, bool)
            if res.path is not None:
                keep[np.asarray(res.path, np.int64)] = True
            keep[q.source] = True
        else:
            # entries <= dist[target] are settled; mask the rest
            keep = dist <= dist[q.target]
    elif q.kind == "bounded":
        keep = dist <= q.bound
    elif q.kind == "knear":
        # the k+1 smallest entries are settled at exit (source included)
        finite = np.flatnonzero(np.isfinite(dist))
        order = finite[np.argsort(dist[finite], kind="stable")]
        order = order[order != q.source][:q.k]
        res.nearest = [(int(v), float(dist[v])) for v in order]
        keep = np.zeros(dist.shape, bool)
        keep[order] = True
        keep[q.source] = True
    else:
        keep = None
    if keep is not None:
        res.dist = np.where(keep, dist, np.inf).astype(dist.dtype)
        res.parent = np.where(keep, parent, -1).astype(parent.dtype)
    return res
