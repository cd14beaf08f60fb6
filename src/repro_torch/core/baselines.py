"""Baseline SSSP implementations the paper compares against (Table 2/3),
the port of ``repro.core.baselines``.

* :func:`dijkstra_host`   — exact host-side Dijkstra (heapq); the test
                            oracle and the work-efficiency yardstick.
* :func:`bellman_ford`    — frontier Bellman-Ford (PQ-BF analogue).
* :func:`delta_stepping`  — Δ-stepping (GAPBS / Graph500 analogue), with
                            the classic light/heavy split per bucket.

Both device baselines take a :class:`~repro_torch.core.graph.DeviceGraph`
and run on its device with plain torch ops (the reference computes them
with ``segment_min`` outside any kernel): a masked ``scatter_reduce``
min, then the min-source-id winner.  They return the engine's
:class:`~repro_torch.core.sssp.SsspMetrics`, whose logical counters equal
the reference's, so nFrontier/nSync/nTrav stay comparable with EIC's.
The reference's ``lax.while_loop`` is a Python loop that reads one flag
per iteration; ``n_host_syncs`` counts the reads.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from . import relax
from .graph import DeviceGraph, HostGraph
from .relax import INF, count
from .sssp import SsspMetrics, _zero_metrics


def dijkstra_host(g: HostGraph, source: int):
    """Exact Dijkstra on the host CSR (float64 accumulation)."""
    n = g.n
    dist = np.full(n, np.inf)
    parent = np.full(n, -1, np.int64)
    dist[source] = 0.0
    parent[source] = source
    visited = np.zeros(n, bool)
    heap = [(0.0, source)]
    row_ptr, col, w = g.row_ptr, g.dst, g.w
    while heap:
        d, u = heapq.heappop(heap)
        if visited[u]:
            continue
        visited[u] = True
        for i in range(row_ptr[u], row_ptr[u + 1]):
            v = col[i]
            nd = d + float(w[i])
            if nd < dist[v]:
                dist[v] = nd
                parent[v] = u
                heapq.heappush(heap, (nd, v))
    return dist, parent


def _initial(g: DeviceGraph, source: int):
    dist = torch.full((g.n,), INF, dtype=torch.float32, device=g.device)
    dist[source] = 0.0
    parent = torch.full((g.n,), -1, dtype=torch.int32, device=g.device)
    parent[source] = source
    return dist, parent


def _relax(g: DeviceGraph, dist, parent, edge_mask, metrics: SsspMetrics):
    """One synchronous relaxation of the edges in ``edge_mask``; returns
    ``(dist, parent, improved, metrics)``."""
    cand = torch.where(edge_mask, dist[g.src] + g.w, INF)
    best, winner = relax.segment_min_with_winner(cand, edge_mask, g.src,
                                                 g.dst, g.n)
    dist, parent, improved = relax.apply_updates(dist, parent, best, winner)
    metrics = metrics._replace(
        n_rounds=metrics.n_rounds + 1,
        n_trav=metrics.n_trav + count(edge_mask),
        n_updates=metrics.n_updates + count(improved))
    return dist, parent, improved, metrics


def _with_syncs(metrics: SsspMetrics, syncs: int, device) -> SsspMetrics:
    return metrics._replace(n_host_syncs=torch.full(
        (), float(syncs), dtype=torch.float32, device=device))


def bellman_ford(g: DeviceGraph, source: int, *, max_iters: int = 1_000_000):
    """Frontier Bellman-Ford: relax every frontier vertex each round.
    Returns ``(dist, parent, metrics)`` on the graph's device."""
    source = int(source)
    dist, parent = _initial(g, source)
    frontier = torch.zeros(g.n, dtype=torch.bool, device=g.device)
    frontier[source] = True
    metrics = _zero_metrics(g.device)
    syncs = 0
    for _ in range(max_iters):
        syncs += 1
        if not frontier.any().item():
            break
        active = frontier[g.src]
        metrics = metrics._replace(
            n_extended=metrics.n_extended + count(frontier))
        dist, parent, frontier, metrics = _relax(g, dist, parent, active,
                                                 metrics)
    return dist, parent, _with_syncs(metrics, syncs, g.device)


def delta_stepping(g: DeviceGraph, source: int, delta, *,
                   max_iters: int = 1_000_000):
    """Classic Δ-stepping with light/heavy edge split per bucket.

    Buckets ``[iΔ, (i+1)Δ)`` processed in ascending order; within a bucket,
    light edges (w < Δ) relax repeatedly (with reinsertion) until the bucket
    is stable, then heavy edges of all bucket members relax once.

    ``delta`` is rounded to float32 first and kept as a 0-d tensor on the
    graph's device, so that every comparison, ``lo + Δ`` and the bucket
    edge ``floor(nxt / Δ) * Δ`` are f32 ops on two tensors, as the
    reference's (on CUDA torch turns a division by a host scalar into a
    multiply by its reciprocal, which can move a bucket edge).  Each
    iteration reads ``(done, any light work)`` once; the read picks the
    light or the heavy branch, as the reference's ``lax.cond``."""
    source = int(source)
    dev = g.device
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev)
    dist, parent = _initial(g, source)
    light = g.w < delta
    already = torch.zeros(g.n, dtype=torch.bool, device=dev)
    lo = torch.zeros((), dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    metrics = _zero_metrics(dev)
    syncs = 0
    for _ in range(max_iters):
        hi = lo + delta
        in_bucket = (dist >= lo) & (dist < hi)
        todo = in_bucket & ~already
        is_done, any_light = torch.stack([done, todo.any()]).tolist()
        syncs += 1
        if is_done:
            break
        if any_light:
            metrics = metrics._replace(
                n_extended=metrics.n_extended + count(todo))
            dist, parent, improved, metrics = _relax(
                g, dist, parent, todo[g.src] & light, metrics)
            # reinsert vertices improved back into the current bucket
            in_b2 = (dist >= lo) & (dist < hi)
            already = (already | todo) & ~(improved & in_b2)
            continue
        dist, parent, _, metrics = _relax(
            g, dist, parent, in_bucket[g.src] & ~light, metrics)
        nxt = torch.where(dist >= hi, dist, INF).min()
        done = ~torch.isfinite(nxt)
        lo = torch.where(done, lo, torch.floor(nxt / delta) * delta)
        already = torch.zeros_like(already)
    return dist, parent, _with_syncs(metrics, syncs, dev)
