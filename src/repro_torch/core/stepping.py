"""Dynamic-stepping heuristic (paper §3.1, Eqs. 1-3), static policy
(port of ``repro.core.stepping``).

Given the current scheduling threshold ``x`` (and the latest dist[]),
choose the window width ``gap(x)``:

    prob(x)  = min(beta, max(sumD(x), 2|E| - sumD(x)) / (2|E|))          (1)
    ratio(x) = 1 - (1 - prob(x)) ** (1 / (prob(x) * highD(x)))           (2)
    gap(x)   = maxW(G, 1)        if highD(x) <= alpha                    (3)
               maxW(G, ratio(x)) otherwise

All scalars are float32 0-d tensors, rounded as the reference rounds
them (``exp``/``log1p`` from :mod:`.f32math`).  The adaptive policy is
not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import f32math, stats

_P_LO = float(np.float32(1e-6))
_P_HI = float(np.float32(1.0 - 1e-6))
_W_FLOOR = float(np.float32(1e-12))


class SteppingParams(NamedTuple):
    alpha: float = 3.0   # paper default
    beta: float = 0.9    # paper default


def prob(sum_d_x: torch.Tensor, n_edges2: torch.Tensor,
         beta: float) -> torch.Tensor:
    """Eq. (1). ``n_edges2`` is 2|E| (the directed slot count)."""
    s = sum_d_x.to(torch.float32)
    two_e = n_edges2.to(torch.float32)
    frac = torch.maximum(s, two_e - s) / torch.clamp(two_e, min=1.0)
    return torch.clamp(frac, max=float(np.float32(beta)))


def ratio(prob_x: torch.Tensor, high_d_x: torch.Tensor) -> torch.Tensor:
    """Eq. (2) — computed in log-space for numerical safety."""
    p = torch.clamp(prob_x, _P_LO, _P_HI)
    expo = 1.0 / (p * torch.clamp(high_d_x, min=1.0))
    return 1.0 - f32math.exp(expo * f32math.log1p(-p))


def gap_from_stats(sd: torch.Tensor, hd: torch.Tensor, rtow: torch.Tensor,
                   n_edges2: torch.Tensor,
                   params: SteppingParams = SteppingParams()) -> torch.Tensor:
    """Eq. (3) given precomputed sumD/highD."""
    p = prob(sd, n_edges2, params.beta)
    r = ratio(p, hd)
    g_adaptive = stats.max_w_of(rtow, r)
    g_full = rtow[-1]
    g = torch.where(hd <= float(np.float32(params.alpha)), g_full, g_adaptive)
    # a zero-width window would stall the outer loop: clamp to the
    # smallest positive LUT entry
    positive = torch.where(rtow > 0, rtow, g_full)
    w_floor = torch.minimum(positive.min(), g_full)
    floor = torch.clamp(w_floor, min=_W_FLOOR)
    return torch.maximum(g, floor)


def gap(dist: torch.Tensor, deg: torch.Tensor, rtow: torch.Tensor,
        n_edges2: torch.Tensor, x: torch.Tensor,
        params: SteppingParams = SteppingParams(),
        bucket: torch.Tensor = None) -> torch.Tensor:
    """Eq. (3): window width for the scheduling threshold ``x``."""
    hd = stats.high_d(dist, deg, x, bucket)
    sd = stats.sum_d(dist, deg, x)
    return gap_from_stats(sd, hd, rtow, n_edges2, params)
