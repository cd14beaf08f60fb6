"""Zipf-skewed multi-graph query traffic for the serving benchmark, the
port's copy of ``repro.data.traffic`` over the port's
:class:`~repro_torch.serve.queries.Query`: the same graphs, count and
seed give the reference's items, field for field.

Real point-to-point traffic (navigation, social-graph lookups) is doubly
skewed: a few *graphs* take most of the load, and within a graph a few
popular *endpoints* (hubs, landmarks) dominate.  Both skews follow a
Zipf law here:

* graph popularity — gid rank ``r`` is drawn with ``P(r) ∝ 1/r^a``;
* endpoint popularity — vertices ranked by degree (hubs first) are drawn
  from the same law, so hot sources/targets are the well-connected ones.

The query-kind mix defaults to point-to-point-dominated (Dong et al.'s
serving observation); full trees are the rare tail.  Bounds for
distance-bounded queries are sampled in units of the graph's maximum
edge weight, k for k-nearest log-uniformly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..serve.queries import Query

__all__ = ["TrafficItem", "zipf_ranks", "make_traffic", "DEFAULT_MIX"]

# serving mix: p2p-dominated, full trees rare
DEFAULT_MIX: Tuple[Tuple[str, float], ...] = (
    ("p2p", 0.55), ("bounded", 0.20), ("knear", 0.15), ("tree", 0.10))


@dataclasses.dataclass(frozen=True)
class TrafficItem:
    """One generated request: the query plus its admission attributes.

    ``arrival_s`` is the item's offset from the start of the stream
    (non-decreasing; 0.0 unless ``make_traffic(..., rate_qps=...)`` draws
    Poisson arrivals) — open-loop load generators sleep until it before
    submitting, closed-loop consumers ignore it."""
    query: Query
    priority: int = 0
    deadline_s: Optional[float] = None
    arrival_s: float = 0.0


def _zipf_probs(n_ranks: int, a: float) -> np.ndarray:
    """Normalized ``P(r) ∝ 1/(r+1)^a`` over ranks [0, n_ranks)."""
    p = 1.0 / np.arange(1, n_ranks + 1, dtype=np.float64) ** a
    return p / p.sum()


def zipf_ranks(rng: np.random.Generator, n_ranks: int, size: int,
               a: float = 1.1) -> np.ndarray:
    """Draw ``size`` ranks in [0, n_ranks) with ``P(r) ∝ 1/(r+1)^a``."""
    return rng.choice(n_ranks, size=size, p=_zipf_probs(n_ranks, a))


def _endpoints(rng, graphs, gids, a):
    """Zipf-by-degree-rank endpoint picker per graph (probability vectors
    precomputed once per gid, not per draw)."""
    rank_of, prob_of = {}, {}
    for gid in gids:
        deg = np.asarray(graphs[gid].deg)
        order = np.argsort(-deg, kind="stable")
        ranks = order[deg[order] > 0]            # degree-ranked, no isolates
        rank_of[gid] = ranks
        prob_of[gid] = _zipf_probs(ranks.size, a)
    def pick(gid):
        return int(rank_of[gid][rng.choice(rank_of[gid].size,
                                           p=prob_of[gid])])
    return pick


def make_traffic(graphs: Dict[str, "HostGraph"], n_queries: int, *,
                 seed: int = 0, zipf_a: float = 1.1,
                 mix: Sequence[Tuple[str, float]] = DEFAULT_MIX,
                 bound_w_scale: Tuple[float, float] = (2.0, 8.0),
                 k_range: Tuple[int, int] = (4, 64),
                 priority_levels: int = 3,
                 deadline_s: Optional[float] = None,
                 rate_qps: Optional[float] = None) -> List[TrafficItem]:
    """Generate a Zipf-skewed query stream over ``graphs``.

    ``graphs`` maps gid -> HostGraph; insertion order is the popularity
    ranking (first = hottest).  ``bound_w_scale`` samples bounded-query
    radii as ``uniform(lo, hi) * max_w``; ``k_range`` bounds k-nearest
    sizes (log-uniform).  Priorities are uniform in
    ``[0, priority_levels)``; ``deadline_s`` (optional) attaches the same
    relative deadline to roughly one query in four.  ``rate_qps`` draws
    Poisson arrival offsets (exponential inter-arrival at that mean
    rate) into ``TrafficItem.arrival_s`` for open-loop replay against
    the router.
    """
    if n_queries < 0:
        raise ValueError("n_queries must be >= 0")
    rng = np.random.default_rng(seed)
    gids = list(graphs)
    kinds, probs = zip(*mix)
    probs = np.asarray(probs, np.float64)
    probs = probs / probs.sum()
    pick_endpoint = _endpoints(rng, graphs, gids, zipf_a)
    g_ranks = zipf_ranks(rng, len(gids), n_queries, zipf_a)
    arrivals = np.zeros(n_queries, np.float64)
    if rate_qps is not None:
        if rate_qps <= 0:
            raise ValueError("rate_qps must be > 0")
        # derived RNG: pacing must not perturb the query stream itself —
        # the same seed replays identical queries with or without arrivals
        arr_rng = np.random.default_rng((seed, 0x9E3779B9))
        arrivals = np.cumsum(arr_rng.exponential(1.0 / rate_qps, n_queries))
    out: List[TrafficItem] = []
    for i in range(n_queries):
        gid = gids[int(g_ranks[i])]
        g = graphs[gid]
        kind = kinds[int(rng.choice(len(kinds), p=probs))]
        source = pick_endpoint(gid)
        kw = {}
        if kind == "p2p":
            kw["target"] = pick_endpoint(gid)
        elif kind == "bounded":
            kw["bound"] = float(rng.uniform(*bound_w_scale) *
                                max(g.max_w, 1e-6))
        elif kind == "knear":
            lo, hi = k_range
            kw["k"] = int(np.exp(rng.uniform(np.log(lo), np.log(hi + 1))))
        out.append(TrafficItem(
            query=Query(gid=gid, source=source, kind=kind, **kw),
            priority=int(rng.integers(0, priority_levels)),
            deadline_s=(deadline_s if deadline_s is not None
                        and rng.random() < 0.25 else None),
            arrival_s=float(arrivals[i])))
    return out
