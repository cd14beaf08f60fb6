"""Vertex-degree / edge-weight statistics (port of ``repro.core.stats``).

* ``sumD(x)``   — total degree of ``VS(x) = {u : dist[u] >= x}``.
* ``highD(x)``  — degree threshold splitting ``VS(x)`` into two halves of
                  (approximately) equal total degree, from a 90-bucket
                  degree histogram.
* ``maxW(G,r)`` — weight quantile, served from the ``RtoW`` LUT.

Every function returns 0-d device tensors and never reads back to the
host.  Integer reductions are exact in any order; they are summed in
int64 and cast back to the reference's int32.
"""
from __future__ import annotations

import functools

import torch

from .graph import RATIO_NUM, N_DEG_BUCKETS, degree_bucket, bucket_representative


@functools.lru_cache(maxsize=None)
def _bucket_reps(device: torch.device) -> torch.Tensor:
    # built once per device: a host-to-device copy inside the solve loop
    # would wait for the stream
    return bucket_representative(device)


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` for a 0-d index tensor, as a device gather (indexing with
    a 0-d tensor may read it back to the host)."""
    return t.index_select(0, idx.reshape(1).to(torch.int64)).reshape(())


def max_w_of(rtow: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """``maxW(G, ratio)`` via the RtoW quantile LUT."""
    idx = torch.clamp(torch.round(ratio * (RATIO_NUM - 1)).to(torch.int64),
                      0, RATIO_NUM - 1)
    return take(rtow, idx)


def sum_d(dist: torch.Tensor, deg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Total degree of vertices with dist >= x (includes unreached, dist=inf)."""
    return torch.where(dist >= x, deg, 0).sum().to(torch.int32)


def _lt_total(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``q < a`` in the total order of the reference's sort comparator
    (NaN above every number), for non-negative inputs."""
    return (q < a) | (torch.isnan(a) & ~torch.isnan(q))


def searchsorted_right(grid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``searchsorted(grid, q, side="right")`` by the reference's own
    fixed-depth binary search, so that a NaN grid point (``0 * inf`` when
    ``ub`` is infinite) sorts as the reference sorts it."""
    g = grid.shape[0]
    low = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    high = torch.full(q.shape, g, dtype=torch.int64, device=q.device)
    for _ in range(g.bit_length()):             # ceil(log2(g + 1)) levels
        mid = (low + high) // 2
        left = _lt_total(q, grid[mid])
        low = torch.where(left, low, mid)
        high = torch.where(left, mid, high)
    return high


def sum_d_grid(dist: torch.Tensor, deg: torch.Tensor,
               grid: torch.Tensor) -> torch.Tensor:
    """Vectorized ``sumD`` over an ascending grid of thresholds."""
    return sum_d_grid_from_hist(grid_hist(dist, deg, grid))


def grid_hist(dist: torch.Tensor, deg: torch.Tensor,
              grid: torch.Tensor) -> torch.Tensor:
    """Degree mass binned by dist into grid intervals."""
    bins = searchsorted_right(grid, dist)               # in [0, G]
    hist = torch.zeros(grid.shape[0] + 1, dtype=torch.int64,
                       device=dist.device)
    return hist.index_add_(0, bins, deg.to(torch.int64)).to(torch.int32)


def sum_d_grid_from_hist(hist: torch.Tensor) -> torch.Tensor:
    # sumD(grid[i]) = sum of hist[j] for j > i  (dist >= grid[i] <=> bin > i)
    suffix = torch.cumsum(hist.flip(0), 0).flip(0).to(torch.int32)
    return suffix[1:]


def degree_hist(dist: torch.Tensor, deg: torch.Tensor, x: torch.Tensor,
                bucket: torch.Tensor = None) -> torch.Tensor:
    """Degree-mass histogram of VS(x).  ``bucket`` is
    ``degree_bucket(deg)``, which callers with a fixed graph compute once."""
    if bucket is None:
        bucket = degree_bucket(deg)
    mass = torch.where(dist >= x, deg, 0).to(torch.int64)
    hist = torch.zeros(N_DEG_BUCKETS, dtype=torch.int64, device=dist.device)
    return hist.index_add_(0, bucket.to(torch.int64), mass).to(torch.int32)


def high_d_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """Weighted-median degree from a histogram."""
    total = hist.sum().to(torch.int32)
    cum = torch.cumsum(hist, 0).to(torch.int32)
    half = (total + 1) // 2
    # first bucket where the cumulative mass reaches half the total
    idx = torch.argmax((cum >= half).to(torch.int32))
    rep = take(_bucket_reps(hist.device), idx)
    one = torch.ones((), dtype=torch.float32, device=hist.device)
    # empty VS(x) -> highD := 1 (neutral; gap() then uses maxW path)
    return torch.where(total > 0, torch.maximum(rep, one), one)


def high_d(dist: torch.Tensor, deg: torch.Tensor, x: torch.Tensor,
           bucket: torch.Tensor = None) -> torch.Tensor:
    """Degree threshold balancing total degree of VS(x) into two halves."""
    return high_d_from_hist(degree_hist(dist, deg, x, bucket))
