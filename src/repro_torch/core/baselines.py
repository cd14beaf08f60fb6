"""Baseline SSSP: exact host-side Dijkstra, the port's test oracle
(port of ``repro.core.baselines.dijkstra_host``)."""
from __future__ import annotations

import heapq

import numpy as np

from .graph import HostGraph


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
