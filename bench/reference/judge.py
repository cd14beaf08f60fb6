"""The comparison that decides ``correct`` for one shortest-path tree.

Two numbers, each with its limit (``LIMITS``):

* ``dist_gap``: the widest relative gap between the program's float32
  distances and the reference's float64 ones, over the vertices the
  reference reaches; infinite where the two reach different vertices or
  the source's distance is not 0.
* ``tree_gap``: for every vertex the program reached other than the
  source, ``parent[v]`` must be a neighbour ``u`` with ``dist[u] + w(u,
  v)``, summed in float32 as the program sums, equal to ``dist[v]``; the
  number is the widest relative gap of that sum (the lightest edge from
  ``parent[v]`` to ``v``), infinite where the parent is no neighbour or
  the source is not its own parent.

The limits sit between the readings of sound runs of the program and
those of the bfloat16 control (``bench/control.py``); PERF.md gives the
readings they were set from.
"""
import torch

from bench.reference.sssp import CHUNK

LIMITS = {"dist_gap": 2e-4, "tree_gap": 1e-6}


def _dist_gap(dp: torch.Tensor, dr: torch.Tensor, source: int) -> float:
    reach = torch.isfinite(dr)
    if not torch.equal(torch.isfinite(dp), reach) or float(dp[source]) != 0:
        return float("inf")
    d = dp.to(torch.float64)
    gap = torch.where(reach & (dr > 0), (d - dr).abs() / dr, 0.0)
    return float(gap.max()) if gap.numel() else 0.0


def _tree_gap(dp, parent, source, eu, ev, ew, chunk) -> float:
    n = dp.shape[0]
    parent = parent.to(torch.int64)
    if int(parent[source]) != source:
        return float("inf")
    # the smallest float32 sum dist[u] + w over the edges from parent[v]
    best = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=dp.device)
    bits = best.view(torch.int32)
    for a, b in ((eu, ev), (ev, eu)):
        for lo in range(0, a.shape[0], chunk):
            hi = lo + chunk
            s = dp[a[lo:hi]] + ew[lo:hi]
            s = torch.where(parent[b[lo:hi]] == a[lo:hi], s, float("inf"))
            bits.scatter_reduce_(0, b[lo:hi], s.view(torch.int32), "amin")
    judged = torch.isfinite(dp)
    judged[source] = False
    d = dp.to(torch.float64)
    gap = torch.where(judged, (best.to(torch.float64) - d).abs() / d, 0.0)
    return float(gap.max()) if gap.numel() else 0.0


def judge(dist: torch.Tensor, parent: torch.Tensor, ref: torch.Tensor,
          source: int, eu: torch.Tensor, ev: torch.Tensor, ew: torch.Tensor,
          chunk: int = CHUNK) -> dict:
    """``{"dist_gap": ..., "tree_gap": ...}`` of one program tree
    (``dist`` float32, ``parent``) against the reference distances
    ``ref`` (float64), on the device of ``eu``."""
    dev = eu.device
    dp = dist.to(dev, torch.float32)
    return {"dist_gap": _dist_gap(dp, ref.to(dev), source),
            "tree_gap": _tree_gap(dp, parent.to(dev), source, eu, ev,
                                  ew.to(dev), chunk)}


def passes(numbers: dict) -> bool:
    """Every number within its limit (an infinite or NaN gap fails)."""
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
