"""Dynamic-stepping heuristic (paper §3.1, Eqs. 1-3) and its policy family
(port of ``repro.core.stepping``).

Given the current scheduling threshold ``x`` (and the latest dist[]),
choose the window width ``gap(x)``:

    prob(x)  = min(beta, max(sumD(x), 2|E| - sumD(x)) / (2|E|))          (1)
    ratio(x) = 1 - (1 - prob(x)) ** (1 / (prob(x) * highD(x)))           (2)
    gap(x)   = maxW(G, 1)        if highD(x) <= alpha                    (3)
               maxW(G, ratio(x)) otherwise

Two policies share these equations (:data:`POLICIES`): ``"static"``, the
paper's fixed parameters, and ``"adaptive"``, where a
:class:`PolicyState` rides in the solve loop and at every step transition
the observed rounds per step and relaxation waste adjust ``alpha``,
``beta`` and a window multiplier ``mult`` (:func:`adaptive_update`).
Windows are pure scheduling, so adapting them leaves dist/parent as they
are.

All scalars are float32 0-d tensors, rounded as the reference rounds
them (``exp``/``log1p`` from :mod:`.f32math`).  ``alpha``/``beta`` are
Python floats (static) or 0-d f32 tensors (adapted); every constant is
the f32 rounding the reference's program uses, so the adapted clamps sit
at ``float32(0.995)``, not at 0.995.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import f32math, stats

#: Stepping-policy names accepted by ``EngineConfig(policy=...)``.
POLICIES = ("static", "adaptive")

_P_LO = float(np.float32(1e-6))
_P_HI = float(np.float32(1.0 - 1e-6))
_W_FLOOR = float(np.float32(1e-12))


def _f32(x) -> float:
    return float(np.float32(x))


class SteppingParams(NamedTuple):
    alpha: float = 3.0   # paper default
    beta: float = 0.9    # paper default


class AdaptivePolicy(NamedTuple):
    """Static hyper-knobs of the ``"adaptive"`` policy."""
    rounds_lo: float = 2.0    # <= this many rounds/step: window too narrow
    rounds_hi: float = 6.0    # > this many rounds/step: window too wide
    waste_hi: float = 0.6     # wasted-relaxation share that means "too wide"
    step: float = 1.3         # multiplicative feedback factor (> 1)
    mult_min: float = 0.25    # clamps for the window multiplier ...
    mult_max: float = 4.0
    alpha_min: float = 1.0    # ... and for the adapted Eq. 1-3 parameters
    alpha_max: float = 64.0
    beta_min: float = 0.3
    beta_max: float = 0.995


DEFAULT_ADAPTIVE = AdaptivePolicy()


class PolicyState(NamedTuple):
    """Per-solve state of the adaptive policy: the adapted ``alpha``,
    ``beta`` and ``mult`` (f32) and the ``SsspMetrics`` counters at the
    previous step transition (int32), from which the next transition
    forms per-step deltas.  0-d tensors, or ``[S]`` in a batched solve."""
    alpha: torch.Tensor
    beta: torch.Tensor
    mult: torch.Tensor
    last_rounds: torch.Tensor
    last_relax: torch.Tensor
    last_updates: torch.Tensor


def policy_init(params: SteppingParams, device=None,
                shape=()) -> PolicyState:
    """Fresh adaptive state: start at the static parameters, mult=1."""
    f = lambda v: torch.full(shape, _f32(v), dtype=torch.float32,
                             device=device)
    i = lambda: torch.zeros(shape, dtype=torch.int32, device=device)
    return PolicyState(alpha=f(params.alpha), beta=f(params.beta),
                       mult=f(1.0), last_rounds=i(), last_relax=i(),
                       last_updates=i())


def effective_params(ps: PolicyState) -> SteppingParams:
    """The adapted parameters as a ``SteppingParams`` of tensors."""
    return SteppingParams(alpha=ps.alpha, beta=ps.beta)


def adaptive_update(ps: PolicyState, n_rounds: torch.Tensor,
                    n_relax: torch.Tensor, n_updates: torch.Tensor,
                    pol: AdaptivePolicy = DEFAULT_ADAPTIVE) -> PolicyState:
    """One feedback step from the counters observed since the last step.

    All inputs are the cumulative int32 ``SsspMetrics`` counters; the
    deltas are formed against the snapshots carried in ``ps``.  Every
    operation is the reference's f32 operation, with its constants
    rounded to f32."""
    f32 = torch.float32
    rounds_d = (n_rounds - ps.last_rounds).to(f32)
    relax_d = (n_relax - ps.last_relax).to(f32)
    upd_d = (n_updates - ps.last_updates).to(f32)
    waste = 1.0 - upd_d / torch.clamp(relax_d, min=1.0)
    too_wide = (rounds_d > _f32(pol.rounds_hi)) | (waste > _f32(pol.waste_hi))
    too_narrow = (rounds_d <= _f32(pol.rounds_lo)) & ~too_wide
    full = lambda v: torch.full_like(waste, _f32(v))
    f = torch.where(too_wide, full(1.0 / pol.step),
                    torch.where(too_narrow, full(pol.step), full(1.0)))
    # mult takes the full factor; alpha/beta move gently (sqrt of it)
    fs = torch.sqrt(f)
    clip = lambda x, lo, hi: torch.clamp(x, _f32(lo), _f32(hi))
    return PolicyState(
        alpha=clip(ps.alpha * fs, pol.alpha_min, pol.alpha_max),
        beta=clip(ps.beta * fs, pol.beta_min, pol.beta_max),
        mult=clip(ps.mult * f, pol.mult_min, pol.mult_max),
        last_rounds=n_rounds, last_relax=n_relax, last_updates=n_updates)


def prob(sum_d_x: torch.Tensor, n_edges2: torch.Tensor,
         beta) -> torch.Tensor:
    """Eq. (1). ``n_edges2`` is 2|E| (the directed slot count); ``beta``
    a float or a 0-d f32 tensor."""
    s = sum_d_x.to(torch.float32)
    two_e = n_edges2.to(torch.float32)
    frac = torch.maximum(s, two_e - s) / torch.clamp(two_e, min=1.0)
    if isinstance(beta, torch.Tensor):
        return torch.minimum(frac, beta)
    return torch.clamp(frac, max=_f32(beta))


def ratio(prob_x: torch.Tensor, high_d_x: torch.Tensor) -> torch.Tensor:
    """Eq. (2) — computed in log-space for numerical safety."""
    p = torch.clamp(prob_x, _P_LO, _P_HI)
    expo = 1.0 / (p * torch.clamp(high_d_x, min=1.0))
    return 1.0 - f32math.exp(expo * f32math.log1p(-p))


def gap_from_stats(sd: torch.Tensor, hd: torch.Tensor, rtow: torch.Tensor,
                   n_edges2: torch.Tensor,
                   params: SteppingParams = SteppingParams(),
                   mult: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. (3) given precomputed sumD/highD.  ``mult`` is the adaptive
    policy's window multiplier (None: the static policy)."""
    p = prob(sd, n_edges2, params.beta)
    r = ratio(p, hd)
    g_adaptive = stats.max_w_of(rtow, r)
    g_full = rtow[-1]
    alpha = params.alpha if isinstance(params.alpha, torch.Tensor) \
        else _f32(params.alpha)
    g = torch.where(hd <= alpha, g_full, g_adaptive)
    # a zero-width window would stall the outer loop: clamp to the
    # smallest positive LUT entry
    positive = torch.where(rtow > 0, rtow, g_full)
    w_floor = torch.minimum(positive.min(), g_full)
    floor = torch.clamp(w_floor, min=_W_FLOOR)
    if mult is None:
        return torch.maximum(g, floor)
    # rescaled windows re-clamp to the same floor
    return torch.maximum(torch.maximum(g, floor) * mult, floor)


def gap(dist: torch.Tensor, deg: torch.Tensor, rtow: torch.Tensor,
        n_edges2: torch.Tensor, x: torch.Tensor,
        params: SteppingParams = SteppingParams(),
        bucket: torch.Tensor = None,
        mult: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. (3): window width for the scheduling threshold ``x``."""
    hd = stats.high_d(dist, deg, x, bucket)
    sd = stats.sum_d(dist, deg, x)
    return gap_from_stats(sd, hd, rtow, n_edges2, params, mult)
