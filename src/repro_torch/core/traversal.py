"""Traversal-optimization heuristic (paper §3.2, Eqs. 4-6 + Function 2)
(port of ``repro.core.traversal``).

Chooses the selection threshold ``ST(lb, ub) <= lb`` that maximizes the
estimated number of skipped edge traversals

    profit(x, lb, ub) = pushed(x, lb, ub) - long(x, lb, ub) - pulled(x, lb, ub)

evaluated, as in the paper's implementation (§4.1), on an ST_NUM-point
grid of candidates.
"""
from __future__ import annotations

import numpy as np
import torch

from . import stats, stepping
from .graph import ST_NUM


def _unit_grid(st_num: int) -> np.ndarray:
    # the reference's float32 linspace(0, 1): i * (1 / (st_num - 1)), then
    # an exact endpoint
    div = st_num - 1
    pts = np.arange(div, dtype=np.float32) * (np.float32(1) / np.float32(div))
    return np.concatenate([pts, np.ones(1, np.float32)])


def profit_terms(x: torch.Tensor, lb: torch.Tensor, y: torch.Tensor,
                 sum_d_x: torch.Tensor, sum_d_lb: torch.Tensor,
                 n_edges2: torch.Tensor, max_w: torch.Tensor):
    """Vectorized (pushed, long, pulled) estimates for candidate(s) ``x``."""
    max_w = torch.clamp(max_w, min=float(np.float32(1e-12)))
    lb0 = torch.maximum(x, lb - max_w)
    ub0 = torch.minimum(y, lb + max_w)
    ub1 = torch.minimum(y, lb0 + max_w)
    sd_x = sum_d_x.to(torch.float32)
    sd_lb = sum_d_lb.to(torch.float32)
    band = torch.clamp(sd_x - sd_lb, min=0.0)  # degree mass of VS(x)\VS(lb)
    pushed = (ub0 - lb) * band / max_w
    pulled = (ub0 - x) * sd_lb / max_w
    long_ = ((ub1 - lb0) * sd_lb / max_w) * band / n_edges2.to(torch.float32)
    return pushed, long_, pulled


def st_grid_points(ub: torch.Tensor, st_num: int = ST_NUM) -> torch.Tensor:
    """Candidate grid over [0, ub] — the paper's ST_NUM-point set."""
    return torch.from_numpy(_unit_grid(st_num)).to(ub.device) * ub


def compute_st(dist: torch.Tensor, deg: torch.Tensor, rtow: torch.Tensor,
               n_edges2: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
               params: stepping.SteppingParams = stepping.SteppingParams(),
               st_num: int = ST_NUM, bucket: torch.Tensor = None,
               unit_grid: torch.Tensor = None, mult=None) -> torch.Tensor:
    """Function 2: selection threshold for the *next* pair ``<ub, ub+gap(ub)>``.

    ``unit_grid`` is ``st_grid_points(1)`` kept on the device by callers
    in a loop (building it copies from the host, which waits for the
    stream).  ``mult`` is the adaptive policy's window multiplier (None
    for the static policy)."""
    sd_ub = stats.sum_d(dist, deg, ub)
    gap_lb = stepping.gap(dist, deg, rtow, n_edges2, lb, params, bucket,
                          mult)
    gap_ub = stepping.gap(dist, deg, rtow, n_edges2, ub, params, bucket,
                          mult)
    grid = st_grid_points(ub, st_num) if unit_grid is None else unit_grid * ub
    sd_grid = stats.sum_d_grid(dist, deg, grid)
    return compute_st_from_stats(grid, sd_grid, sd_ub, gap_lb, gap_ub,
                                 rtow, n_edges2, ub)


def compute_st_from_stats(grid, sd_grid, sd_ub, gap_lb, gap_ub, rtow,
                          n_edges2, ub) -> torch.Tensor:
    """Function 2 core, given the statistics."""
    max_w = rtow[-1]
    n_e = n_edges2.to(torch.int32) // 2  # |E|
    # line 2: statistics-extraction shortcut / full-width window => push-only
    early_push = (sd_ub >= n_e) | (gap_lb >= max_w)
    # line 5: next window is full-width => st = ub - maxW
    early_band = gap_ub >= max_w
    y = ub + gap_ub
    pushed, long_, pulled = profit_terms(
        grid, ub, y, sd_grid, sd_ub, n_edges2, max_w)
    profit = pushed - long_ - pulled
    best = torch.argmax(profit)         # first maximum; NaN counts as max
    st_grid = torch.where(stats.take(profit, best) > 0,
                          stats.take(grid, best), ub)
    st = torch.where(early_band, torch.clamp(ub - max_w, min=0.0), st_grid)
    return torch.where(early_push, ub, st)
