"""The heuristic SSSP algorithm (paper §3.3, Algorithm 2 + Function 1/2),
single device (port of ``repro.core.sssp``): the full tree, the
early-exit goals (p2p, bounded, knear) and ALT-pruned p2p queries,
unidirectional or bidirectional, under the static or the adaptive
stepping policy, one source at a time (:func:`sssp`) or a batch of
sources in one loop (:func:`sssp_batch`), with an optional per-round
trace (:mod:`repro_torch.obs.trace`); and the repair loop of streaming
deltas (:func:`repair_relax`).

The reference flattens the solve into one ``lax.while_loop`` on the
device.  Here the loop is Python and the state stays in device tensors
(``lb``, ``ub``, ``st`` and ``done`` are 0-d tensors).  Each iteration
runs one round of windowed relaxation through a backend from
:mod:`.relax` (or, with ``fused_rounds > 0`` on the blocked backend, up
to that many rounds in one call of the fused kernel); when the frontier
empties, the same iteration performs the step transition (Function 2's
``computeST``, the dynamic-stepping ``gap``, Function 1's pull phase and
the empty-window fast-forward).

Host syncs: the loop reads one small tensor per iteration, carrying both
``done`` (set by the previous transition) and ``any(frontier)`` after
this iteration's round.  The round that follows the final transition
therefore runs on an empty frontier and is discarded (it changes no
logical state).  Conditional device work (the bootstrap tightening, the
pull phase) is computed and selected with ``torch.where``, never
branched on.  The goal test runs on the device and is ORed into ``done``
at each transition, so a query reads nothing more than a tree solve.
``n_host_syncs`` counts the reads.

Options come as an :class:`~repro_torch.core.config.EngineConfig`
(``config=``) or as the loose keywords the reference takes, never both
(:meth:`EngineConfig.from_loose`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from . import relax, stats, stepping, traversal
from ..obs import profiling
from ..obs.trace import TraceBuf, trace_append, trace_init
from .config import (P2P_MODES, ConfigError, EngineConfig,
                     FacadeDeprecationWarning, as_resolved, resolve_devices)
from .graph import BlockedGraph, DeviceGraph, HostGraph, degree_bucket
from .relax import INF, INT_MAX, count

__all__ = ["sssp", "sssp_batch", "sssp_p2p", "sssp_bounded", "sssp_knear",
           "repair_relax", "prepare_layout", "SsspMetrics",
           "LOGICAL_METRIC_FIELDS", "PHYSICAL_METRIC_FIELDS", "metrics_dict",
           "normalized_metrics", "GOALS", "P2P_MODES", "goal_param_array",
           "INF", "INT_MAX"]

# Early-exit query goals.  Each stops once its answer is settled (every
# vertex with dist < lb is final, relax.settled_mask):
#   "tree"    no goal: run until every reachable vertex settles;
#   "p2p"     stop once the target (the goal parameter) settles; its dist
#             and parent chain then equal the tree solve's bit for bit;
#   "bounded" stop once lb > D: every vertex with dist <= D is settled;
#   "knear"   stop once k + 1 vertices (the source and its k nearest) are.
GOALS = ("tree", "p2p", "bounded", "knear")


def goal_param_array(goal: str, params) -> torch.Tensor:
    """The goal parameter(s) as a CPU tensor in the dtype the engine
    takes: int32 (p2p target, knear k), float32 (bounded D), int32 zeros
    for the tree."""
    if goal not in GOALS:
        raise ValueError(f"unknown goal {goal!r}; expected one of {GOALS}")
    if goal == "tree":
        shape = () if params is None or np.ndim(params) == 0 \
            else (len(params),)
        return torch.zeros(shape, dtype=torch.int32)
    if params is None:
        raise ValueError(f"goal {goal!r} requires a parameter "
                         "(target / bound / k)")
    dtype = np.float32 if goal == "bounded" else np.int32
    return torch.from_numpy(np.array(params, dtype))


def _check_goal_bounds(goal: str, gp: torch.Tensor, n: int) -> None:
    """Reject p2p targets outside ``[0, n)`` (a gather would clamp or
    fault where the reference clamps)."""
    if goal != "p2p":
        return
    t = gp.cpu().numpy()
    if t.size and (int(t.min()) < 0 or int(t.max()) >= n):
        raise ValueError(f"p2p target(s) {t} out of range for graph "
                         f"with n={n}")


def _goal_reached(goal: str, goal_param, dist, lb) -> torch.Tensor:
    """Whether the query goal is settled at window lower bound ``lb`` (a
    0-d bool on the device)."""
    if goal == "tree":
        return torch.zeros((), dtype=torch.bool, device=dist.device)
    if goal == "p2p":
        return relax.at(dist, goal_param) < lb
    if goal == "bounded":
        return lb > goal_param
    if goal == "knear":
        return count(relax.settled_mask(dist, lb)) >= goal_param + 1
    raise ValueError(f"unknown goal {goal!r}; expected one of {GOALS}")


class SsspMetrics(NamedTuple):
    n_rounds: torch.Tensor      # synchronized relaxation rounds ("nSync" raw)
    n_steps: torch.Tensor       # scheduling-threshold pairs constructed
    n_extended: torch.Tensor    # extended paths ("nFrontier" raw)
    n_trav: torch.Tensor        # edge traversals, push model
    n_pull_trav: torch.Tensor   # edge traversals, pull model (requests)
    n_relax: torch.Tensor       # relaxation attempts (created paths)
    n_updates: torch.Tensor     # successful relaxations (dist improvements)
    n_pruned: torch.Tensor      # candidates cut by the ALT bound
    n_tiles_scanned: torch.Tensor  # blocked layouts: tiles actually run
    n_tiles_dense: torch.Tensor    # blocked layouts: dense-grid cost
    n_invocations: torch.Tensor    # kernel launches
    n_host_syncs: torch.Tensor     # device-to-host reads of the solve loop


# The physical counters describe this port's layout, launches and host
# syncs and are excluded from parity checks; the logical ones must equal
# the reference's bit for bit.
PHYSICAL_METRIC_FIELDS = ("n_tiles_scanned", "n_tiles_dense",
                          "n_invocations", "n_host_syncs")
LOGICAL_METRIC_FIELDS = tuple(f for f in SsspMetrics._fields
                              if f not in PHYSICAL_METRIC_FIELDS)


class SsspState(NamedTuple):
    dist: torch.Tensor
    parent: torch.Tensor
    frontier: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    st: torch.Tensor
    done: torch.Tensor
    metrics: SsspMetrics


def _zero_metrics(device) -> SsspMetrics:
    def zero(name):
        dtype = torch.float32 if name in PHYSICAL_METRIC_FIELDS \
            else torch.int32
        return torch.zeros((), dtype=dtype, device=device)
    return SsspMetrics(**{name: zero(name) for name in SsspMetrics._fields})


class _Consts(NamedTuple):
    """Per-solve device constants, built once before the loop."""
    params: stepping.SteppingParams
    bucket: torch.Tensor      # degree_bucket(g.deg)
    unit_grid: torch.Tensor   # st_grid_points(1)
    high_d0: torch.Tensor     # highD(0) of the bootstrap step


def _relax_round(backend: relax.RelaxBackend, layout, st_: SsspState,
                 alt_lb=None, prune_bound=None, slots=None) -> SsspState:
    """One synchronized round of push-model edge relaxations; with
    ``alt_lb``/``prune_bound`` (ALT p2p) the backend cuts candidates that
    cannot improve the target (:func:`relax.alt_prune`).  On a stacked
    ``[S, n]`` state, ``slots`` (a :class:`relax.Slots`) names the slots
    relaxed, all in one backend call."""
    extra = () if alt_lb is None else (alt_lb, prune_bound)
    kw = {} if slots is None else dict(active=slots)
    new_dist, new_parent, rm = backend.relax_window(
        layout, st_.dist, st_.parent, st_.frontier, st_.lb, st_.ub, *extra,
        **kw)
    m = st_.metrics
    live = st_.frontier.any() if slots is None \
        else st_.frontier.any(dim=1) & slots.mask
    metrics = m._replace(
        n_rounds=m.n_rounds + live.to(torch.int32),
        n_extended=m.n_extended + rm.n_extended,
        n_trav=m.n_trav + rm.n_trav,
        n_relax=m.n_relax + rm.n_relax,
        n_updates=m.n_updates + rm.n_updates,
        n_pruned=m.n_pruned + rm.n_pruned,
        n_tiles_scanned=m.n_tiles_scanned + rm.n_tiles_scanned,
        n_tiles_dense=m.n_tiles_dense + rm.n_tiles_dense,
        n_invocations=m.n_invocations + rm.n_invocations)
    return st_._replace(dist=new_dist, parent=new_parent,
                        frontier=rm.improved, metrics=metrics)


def _fused_relax_rounds(bg, st_: SsspState, fused_rounds: int, alt_lb=None,
                        prune_ub=None, prune_infl=None,
                        prune_tgt=None) -> SsspState:
    """Up to ``fused_rounds`` synchronized rounds in one call of the fused
    kernel: the twin of calling :func:`_relax_round` once per round until
    the window settles, with the same dist/parent/frontier and logical
    counters.  With ALT the kernel takes the prune bound ``min(prune_ub,
    dist[prune_tgt] * prune_infl)`` afresh each round."""
    new_dist, new_parent, new_front, cnt = relax.blocked_fused_rounds(
        bg, st_.dist, st_.parent, st_.frontier, st_.lb, st_.ub,
        fused_rounds=fused_rounds, alt_lb=alt_lb, prune_ub=prune_ub,
        prune_infl=prune_infl, prune_tgt=prune_tgt)
    m = st_.metrics
    n_exec = cnt[6].to(torch.float32)
    metrics = m._replace(
        n_rounds=m.n_rounds + cnt[4],
        n_trav=m.n_trav + cnt[0],
        n_relax=m.n_relax + cnt[1],
        n_updates=m.n_updates + cnt[2],
        n_extended=m.n_extended + cnt[3],
        n_pruned=m.n_pruned + cnt[7],
        n_tiles_scanned=m.n_tiles_scanned + cnt[5].to(torch.float32),
        # the dense-grid comparator charges one full grid per round
        n_tiles_dense=m.n_tiles_dense + n_exec * bg.dense_grid_tiles,
        n_invocations=m.n_invocations + 1)
    return st_._replace(dist=new_dist, parent=new_parent,
                        frontier=new_front, metrics=metrics)


def _bootstrap_ub(g: DeviceGraph, st_: SsspState,
                  high_d0: torch.Tensor) -> SsspState:
    """Algo 2 l.18-20: during the first step, tighten ub to the shortest
    known path linking s to a vertex of degree >= highD(0) (per slot of
    a stacked ``[S, n]`` state)."""
    mask = (g.deg.to(torch.float32) >= high_d0) & (st_.dist > 0)
    cand = torch.where(mask, st_.dist, INF).amin(dim=-1)
    ub = torch.where(st_.lb <= 0.0, torch.minimum(st_.ub, cand), st_.ub)
    return st_._replace(ub=ub)


def _min_pending(g: DeviceGraph, dist, ub, alt_lb=None, bound=None):
    """Smallest candidate path length at or above ``ub`` (inf if none).
    With ALT a candidate the bound would cut cannot improve the target,
    so it neither keeps the solve going nor anchors the fast-forward."""
    pend = dist[g.src] + g.w
    pend = torch.where(pend >= ub, pend, INF)
    if alt_lb is not None:
        pend = torch.where(pend + alt_lb[g.dst] > bound, INF, pend)
    return pend.min()


def _pull_phase(g: DeviceGraph, dist, parent, st, lb, ub, metrics,
                alt_lb=None, prune_bound=None):
    """Function 1's pull phase: settled band [st, lb) answers requests from
    unsettled vertices.  Returns the updated state and the metrics.  With
    ALT the requester (``g.src``) receives the update, so requests with
    ``cand + alt_lb[src] > prune_bound`` are cut."""
    dv = dist[g.dst]
    # edges a pull scan touches: requester unsettled, weight short enough
    scan = (dist[g.src] > lb) & (g.w < ub - st)
    # requests created (responder side; w < ub - st is implied)
    mask = (dv >= st) & (dv < lb) & (dv + g.w < ub)
    cand = torch.where(mask, dv + g.w, INF)
    n_pruned = torch.zeros((), dtype=torch.int32, device=dist.device)
    if alt_lb is not None:
        mask, pruned = relax.alt_prune(cand, mask, alt_lb[g.src],
                                       prune_bound)
        cand = torch.where(mask, cand, INF)
        n_pruned = count(pruned)
    best, winner = relax.segment_min_with_winner(cand, mask, g.dst, g.src,
                                                 g.n)
    new_dist, new_parent, improved = relax.apply_updates(
        dist, parent, best, winner, gate=dist > lb)
    metrics = metrics._replace(
        n_pull_trav=metrics.n_pull_trav + count(scan),
        n_extended=metrics.n_extended + count(improved & (g.deg > 1)),
        n_relax=metrics.n_relax + count(mask),
        n_updates=metrics.n_updates + count(improved),
        n_pruned=metrics.n_pruned + n_pruned,
        n_rounds=metrics.n_rounds + 1)      # the pull phase is a round/sync
    return new_dist, new_parent, metrics


def _transition(g: DeviceGraph, st_: SsspState, c: _Consts,
                min_pending=_min_pending, pull_phase=_pull_phase,
                goal: str = "tree", goal_param=None, alt_lb=None,
                bound_of=None, ps: stepping.PolicyState = None):
    """Step transition (Algo 2 l.22 + Function 1/2 + fast-forward and
    termination).

    ``min_pending(g, dist, ub)`` and ``pull_phase(g, dist, parent, st,
    lb, ub, metrics)`` are the two places that read edges; the sharded
    engine passes versions that run over its local slab and merge across
    ranks.  Everything else reads only ``g.deg``, ``g.rtow``,
    ``g.n_edges2`` and the state.  ``goal``/``goal_param`` end the solve
    once the goal settles; ``alt_lb`` with ``bound_of(dist)`` (the prune
    bound at this dist) cuts pending candidates and pull requests that
    cannot improve the p2p target.

    With the adaptive policy, ``ps`` carries the
    :class:`~repro_torch.core.stepping.PolicyState`: the transition first
    folds the counters observed since the previous step into it, then
    sizes the next window from the adapted parameters, and returns
    ``(state, ps)``; with ``ps`` None (static) it returns the state."""
    dist, parent = st_.dist, st_.parent
    lb, ub = st_.lb, st_.ub
    alt = () if alt_lb is None else (alt_lb, bound_of(dist))

    # smallest pending candidate path length (>= ub); inf <=> done
    min_pending = min_pending(g, dist, ub, *alt)
    done = ~torch.isfinite(min_pending)

    params, mult = c.params, None
    if ps is not None:
        m = st_.metrics
        ps = stepping.adaptive_update(ps, m.n_rounds, m.n_relax,
                                      m.n_updates)
        params, mult = stepping.effective_params(ps), ps.mult
    st_next = traversal.compute_st(dist, g.deg, g.rtow, g.n_edges2, lb, ub,
                                   params, bucket=c.bucket,
                                   unit_grid=c.unit_grid, mult=mult)
    lb2 = ub
    gap2 = stepping.gap(dist, g.deg, g.rtow, g.n_edges2, lb2, params,
                        c.bucket, mult)
    ub2 = lb2 + gap2
    # empty-window fast-forward (exact: no shortest path in the skip)
    ffwd = (min_pending >= ub2) & ~done
    lb2 = torch.where(ffwd, min_pending, lb2)
    gap3 = stepping.gap(dist, g.deg, g.rtow, g.n_edges2, lb2, params,
                        c.bucket, mult)
    ub2 = torch.where(ffwd, lb2 + gap3, ub2)
    st_next = torch.minimum(st_next, lb2)

    # the pull phase runs when st < lb; computed always and selected, so
    # that the decision needs no host read
    pull = st_next < lb2
    p_dist, p_parent, p_m = pull_phase(g, dist, parent, st_next, lb2, ub2,
                                       st_.metrics, *alt)
    dist = torch.where(pull, p_dist, dist)
    parent = torch.where(pull, p_parent, parent)
    metrics = SsspMetrics(*[torch.where(pull, a, b)
                            for a, b in zip(p_m, st_.metrics)])

    # the settled set grows only here, so the goal test is exact here
    done = done | _goal_reached(goal, goal_param, dist, lb2)
    frontier = relax.window_frontier(dist, st_next, lb2, ub2, g.rtow[-1])
    frontier = frontier & ~done
    metrics = metrics._replace(
        n_steps=metrics.n_steps + (~done).to(torch.int32))
    out = st_._replace(dist=dist, parent=parent, frontier=frontier,
                       lb=lb2, ub=ub2, st=st_next, done=done,
                       metrics=metrics)
    return out if ps is None else (out, ps)


def _consts(deg: torch.Tensor, alpha: float, beta: float) -> _Consts:
    dev = deg.device
    bucket = degree_bucket(deg)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    deg_f0 = torch.zeros(deg.shape[0], dtype=torch.float32, device=dev)
    return _Consts(params=stepping.SteppingParams(alpha=alpha, beta=beta),
                   bucket=bucket,
                   unit_grid=traversal.st_grid_points(
                       torch.ones((), dtype=torch.float32, device=dev)),
                   high_d0=stats.high_d(deg_f0, deg, zero, bucket))


def _initial_state(n: int, source: int, dev) -> SsspState:
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dist0 = torch.full((n,), INF, dtype=torch.float32, device=dev)
    dist0[source] = 0.0
    parent0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    parent0[source] = source
    frontier0 = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier0[source] = True
    # the source's own pop is the first extended path
    metrics0 = _zero_metrics(dev)
    metrics0 = metrics0._replace(n_extended=metrics0.n_extended + 1)
    return SsspState(dist=dist0, parent=parent0, frontier=frontier0,
                     lb=zero, ub=torch.full((), INF, device=dev), st=zero,
                     done=torch.zeros((), dtype=torch.bool, device=dev),
                     metrics=metrics0)


# the SsspMetrics fields a trace record holds as f32 deltas
_TRACE_PHYSICAL = ("n_tiles_scanned", "n_tiles_dense", "n_invocations")


class _TraceSnap(NamedTuple):
    """What a trace record reads of the state before an iteration, copied
    (the batched loop writes rows of its state in place)."""
    frontier: torch.Tensor   # frontier size
    window: torch.Tensor     # lb, ub, st on the last axis
    done: torch.Tensor
    counts: torch.Tensor     # the logical counters on the last axis
    physical: torch.Tensor   # the _TRACE_PHYSICAL counters


def _trace_snap(s: SsspState) -> _TraceSnap:
    m = s.metrics
    return _TraceSnap(
        frontier=count(s.frontier),
        window=torch.stack([s.lb, s.ub, s.st], dim=-1),
        done=s.done.clone(),
        counts=torch.stack([getattr(m, f) for f in LOGICAL_METRIC_FIELDS],
                           dim=-1),
        physical=torch.stack([getattr(m, f) for f in _TRACE_PHYSICAL],
                             dim=-1))


def _trace_record(s0: _TraceSnap, s1: SsspState, buf: TraceBuf,
                  rows=None) -> None:
    """Append the record of one iteration, from the state before it
    (``s0``) and after it (``s1``), to ``buf`` (the reference's
    ``_trace_record``); on a stacked state, for the slots in ``rows``.
    Every counter column is the iteration's exact delta; ``iter`` is the
    ring's write count, which is the iteration's index, since a record is
    written every iteration that a solve (or a slot) runs."""
    m1 = s1.metrics
    counts = (torch.stack([getattr(m1, f) for f in LOGICAL_METRIC_FIELDS],
                          dim=-1) - s0.counts).unbind(-1)
    physical = (torch.stack([getattr(m1, f) for f in _TRACE_PHYSICAL],
                            dim=-1) - s0.physical).unbind(-1)
    # the transition ran iff it advanced a step (or ended the solve)
    stepped = (counts[1] > 0) | (s1.done & ~s0.done)
    ivals = dict(iter=buf.n, frontier=s0.frontier, stepped=stepped,
                 **dict(zip(LOGICAL_METRIC_FIELDS, counts)))
    fvals = dict(zip(("lb", "ub", "st"), s0.window.unbind(-1)),
                 **dict(zip(_TRACE_PHYSICAL, physical)))
    trace_append(buf, ivals, fvals, rows)


def _solve_loop(g, s: SsspState, c: _Consts, relax_step, transition,
                max_iters: int, buf: TraceBuf | None = None, *,
                tighten=None, any_front=None, snap=_trace_snap):
    """The stepping loop: a relaxation call, the bootstrap tightening, one
    host read of ``(done, any(frontier))``, and the step transition when
    the frontier is empty.  With ``buf`` every iteration that counts
    appends its record (the dropped last round does not).  ``g`` needs
    ``deg``; returns ``(dist, parent, metrics)``.

    The block-sharded engines (v2/v3) pass three hooks: ``tighten(s)`` in
    place of the bootstrap tightening, ``any_front(s)``, a 0-d tensor
    that holds iff some rank has a frontier, and ``snap(s)``, the trace's
    view of the state before an iteration."""
    if tighten is None:
        tighten = lambda s: _bootstrap_ub(g, s, c.high_d0)
    if any_front is None:
        any_front = lambda s: s.frontier.any()
    syncs = 0
    for _ in range(max_iters):
        prev = s
        before = None if buf is None else snap(s)
        s = tighten(relax_step(s))
        done, front = torch.stack([s.done, any_front(s)]).tolist()
        syncs += 1
        if done:
            # the previous transition finished the solve: this round ran
            # on an empty frontier and is dropped
            s = prev
            break
        if not front:
            s = transition(s)
        if buf is not None:
            _trace_record(before, s, buf)
    metrics = s.metrics._replace(n_host_syncs=torch.full(
        (), float(syncs), dtype=torch.float32, device=g.deg.device))
    return s.dist, s.parent, metrics


def _policy_transition(policy: str, params, device, transition):
    """The loop's transition: ``transition(s)`` itself (static), or, for
    the adaptive policy, ``transition(s, ps=...)`` with the
    :class:`~repro_torch.core.stepping.PolicyState` kept between
    calls."""
    if policy == "static":
        return transition
    ps = [stepping.policy_init(params, device)]

    def adaptive(s):
        s, ps[0] = transition(s, ps=ps[0])
        return s
    return adaptive


def _run(g: DeviceGraph, layout, source: int, backend: relax.RelaxBackend,
         max_iters: int, alpha: float, beta: float, fused_rounds: int = 0,
         goal: str = "tree", goal_param=None, alt=None,
         policy: str = "static", buf: TraceBuf | None = None):
    """One SSSP computation; returns ``(dist, parent, metrics)``.
    ``fused_rounds > 0`` (blocked layouts) relaxes through the fused
    kernel, up to that many rounds per call.  ``goal_param`` is a 0-d
    device tensor; ``alt`` (an :class:`relax.AltData`, p2p only) prunes
    with the landmark bounds toward the target; ``policy`` is
    ``"static"`` or ``"adaptive"``; ``buf`` records the iterations."""
    c = _consts(g.deg, alpha, beta)
    s = _initial_state(g.n, source, g.device)
    alt_lb = bound_of = None
    fused_alt = ()
    if alt is not None:
        tgt = goal_param
        alt_lb = relax.alt_lower_bounds(alt.D, tgt, alt.delta, alt.sym)
        infl = 1.0 + 4.0 * alt.delta
        src_t = torch.tensor(source, dtype=torch.int32, device=g.device)
        prune_ub = relax.alt_seed_ub(alt.D, src_t, tgt, infl, alt.sym)
        # the best known s->t length, inflated so that the engine's own f32
        # path sums always survive the cut; a 0-d device tensor, no read
        bound_of = lambda dist: torch.minimum(
            prune_ub, relax.at(dist, tgt) * infl)
        fused_alt = (alt_lb, prune_ub, infl, tgt)
    if fused_rounds > 0:
        relax_step = lambda s: _fused_relax_rounds(layout, s, fused_rounds,
                                                   *fused_alt)
    elif alt is None:
        relax_step = lambda s: _relax_round(backend, layout, s)
    else:
        relax_step = lambda s: _relax_round(backend, layout, s, alt_lb,
                                            bound_of(s.dist))
    return _solve_loop(g, s, c, relax_step, _policy_transition(
        policy, c.params, g.device,
        lambda s, **ps: _transition(g, s, c, goal=goal,
                                    goal_param=goal_param, alt_lb=alt_lb,
                                    bound_of=bound_of, **ps)), max_iters,
        buf)


def _pick(fwd: torch.Tensor, a: SsspState, b: SsspState) -> SsspState:
    """``a`` where the 0-d bool ``fwd`` holds, else ``b``, field by field
    on the device."""
    def sel(x, y):
        return SsspMetrics(*map(sel, x, y)) if isinstance(x, SsspMetrics) \
            else torch.where(fwd, x, y)
    return SsspState(*map(sel, a, b))


def _run_bidi(g: DeviceGraph, layout, source: int, target: int, backend,
              max_iters: int, alpha: float, beta: float, fused_rounds: int,
              alt: relax.AltData):
    """Bidirectional meet-in-the-middle p2p (port of the reference's
    ``_run_bidi``).

    A forward solve from ``source`` and a backward one from ``target``
    (the graph is symmetric) alternate iterations: the side whose window
    lower bound trails advances, and the backward side freezes once it is
    done or once ``lb_f + lb_b >= mu``, where ``mu = min_v dist_f[v] +
    dist_b[v]`` is the shortest meeting path seen so far.  ``mu`` tightens
    both sides' prune bounds through ``min(seed_ub, mu * infl)``.  The
    forward side is authoritative: it stops when the target settles, and
    its dist[target] and parent chain equal the unidirectional solve's.
    Metrics are summed over both sides.

    The side is chosen on the device: the advancing side's state is
    selected from the two with ``torch.where``, relaxed (and stepped when
    its frontier empties) and written back.  The choice depends on the
    previous iteration's transition, so a host-side choice would need a
    second read per iteration; here the loop keeps the one read of
    ``(forward done, any frontier)`` of the tree solve.
    """
    dev = g.device
    c = _consts(g.deg, alpha, beta)
    infl = 1.0 + 4.0 * alt.delta
    src_t, tgt_t = (torch.tensor(v, dtype=torch.int32, device=dev)
                    for v in (source, target))
    lb_f = relax.alt_lower_bounds(alt.D, tgt_t, alt.delta, alt.sym)
    lb_b = relax.alt_lower_bounds(alt.D, src_t, alt.delta, alt.sym)
    seed = relax.alt_seed_ub(alt.D, src_t, tgt_t, infl, alt.sym)
    sf = _initial_state(g.n, source, dev)
    sb = _initial_state(g.n, target, dev)
    mu = torch.full((), INF, dtype=torch.float32, device=dev)
    syncs = 0
    for _ in range(2 * max_iters):
        prev = sf, sb, mu
        frozen = sb.done | (sf.lb + sb.lb >= mu)
        fwd = frozen | (sf.lb <= sb.lb)
        s = _pick(fwd, sf, sb)
        alt_lb = torch.where(fwd, lb_f, lb_b)
        goal_v = torch.where(fwd, tgt_t, src_t)
        ub_eff = torch.minimum(seed, mu * infl)
        bound_of = lambda dist: torch.minimum(
            ub_eff, relax.at(dist, goal_v) * infl)
        if fused_rounds > 0:
            s = _fused_relax_rounds(layout, s, fused_rounds, alt_lb, ub_eff,
                                    infl, goal_v)
        else:
            s = _relax_round(backend, layout, s, alt_lb, bound_of(s.dist))
        s = _bootstrap_ub(g, s, c.high_d0)
        done, any_front = torch.stack([sf.done, s.frontier.any()]).tolist()
        syncs += 1
        if done:
            # the forward side finished at the previous transition: this
            # iteration is dropped, as in the single-side loop
            sf, sb, mu = prev
            break
        if not any_front:
            s = _transition(g, s, c, goal="p2p", goal_param=goal_v,
                            alt_lb=alt_lb, bound_of=bound_of)
        sf, sb = _pick(fwd, s, sf), _pick(fwd, sb, s)
        mu = torch.minimum(mu, (sf.dist + sb.dist).min())
    metrics = SsspMetrics(*[a + b for a, b in zip(sf.metrics, sb.metrics)])
    metrics = metrics._replace(n_host_syncs=torch.full(
        (), float(syncs), dtype=torch.float32, device=dev))
    return sf.dist, sf.parent, metrics


def repair_relax(layout, dist, parent, frontier, *, backend="segment_min",
                 max_iters=1_000_000, fused_rounds=0):
    """Monotone re-relaxation to fixpoint from a repaired tentative state
    (the engine hook of :mod:`repro_torch.delta`).

    Runs synchronized full-window rounds (``lb = 0``, ``ub = +inf``)
    through ``backend`` on ``layout`` (``segment_min``: the
    ``DeviceGraph``; ``blocked``: a ``BlockedGraph``, one ``edge_relax``
    call a round), or with ``fused_rounds > 0`` through the fused kernel
    (blocked layouts only; at ``lb = 0`` it runs one round a call, as the
    reference's does), until no distance improves or ``max_iters`` calls
    ran.  Each round's frontier
    is exactly the vertices the previous round improved, so the work
    follows the delta's blast radius, not the graph.  From a valid
    upper-bound state whose frontier covers every vertex that can start
    an improvement (:func:`repro_torch.delta.repair` builds one), the
    fixpoint dist is bitwise a from-scratch solve's on the patched graph
    (the same relaxation primitives and tie-breaks as the stepping loop,
    and the rounded fixpoint does not depend on the schedule), and so is
    parent wherever two paths do not tie exactly in f32.

    The loop reads the host once per call (whether the frontier is
    empty); no step transition runs.  Metrics start from zero and count
    only the repair's own work.  Returns ``(dist, parent, metrics)`` on
    the layout's device.
    """
    be = relax.get_backend(backend)
    if fused_rounds > 0 and not isinstance(layout, BlockedGraph):
        raise ConfigError(
            "fused_rounds needs a blocked layout for repair; got "
            f"{type(layout).__name__}")
    dev = layout.w.device
    dist, parent, frontier = (torch.as_tensor(x).to(dev, dtype) for x, dtype
                              in ((dist, torch.float32),
                                  (parent, torch.int32),
                                  (frontier, torch.bool)))
    n = dist.shape[0]
    if parent.shape != (n,) or frontier.shape != (n,):
        raise ValueError("dist/parent/frontier shapes disagree")
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    s = SsspState(dist=dist, parent=parent, frontier=frontier, lb=zero,
                  ub=torch.full((), INF, device=dev), st=zero,
                  done=torch.zeros((), dtype=torch.bool, device=dev),
                  metrics=_zero_metrics(dev))
    if fused_rounds > 0:
        step = lambda s: _fused_relax_rounds(layout, s, fused_rounds)
    else:
        step = lambda s: _relax_round(be, layout, s)
    with profiling.annotate("repro:repair_dispatch"):
        go, syncs = bool(frontier.any()), 1
        for _ in range(max_iters):
            if not go:
                break
            s = step(s)
            go, syncs = bool(s.frontier.any()), syncs + 1
    metrics = s.metrics._replace(n_host_syncs=torch.full(
        (), float(syncs), dtype=torch.float32, device=dev))
    return s.dist, s.parent, metrics


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another; with no card and no explicit CPU request, this raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


def _on_device(g, dev: torch.device) -> DeviceGraph:
    if isinstance(g, HostGraph):
        return g.to_device(dev)
    if g.device.type != dev.type or (
            dev.index is not None and g.device.index != dev.index):
        raise ValueError(f"graph is on {g.device}, the solve on {dev}")
    return g


_LAYOUT_OPTS = ("block_v", "tile_e")


def _check_layout_opts(opts: dict) -> None:
    """Reject options other than the blocked layout's, as the reference
    rejects unknown engine options."""
    unknown = sorted(set(opts) - set(_LAYOUT_OPTS))
    if unknown:
        raise TypeError(f"unknown engine options {unknown}; the layout "
                        f"takes {list(_LAYOUT_OPTS)}")


def prepare_layout(g, backend="segment_min", *, device=None,
                   **backend_opts):
    """Build a backend's graph layout once (host-side preprocessing);
    ``backend_opts`` are ``block_v``/``tile_e``."""
    _check_layout_opts(backend_opts)
    g = _on_device(g, resolve_device(device))
    be = relax.get_backend(backend)
    with profiling.annotate(f"repro:prepare_layout:{be.name}"):
        return be.prepare(g, **backend_opts)


_CONFIG_FIELDS = frozenset(f.name for f in dataclasses.fields(EngineConfig))


def _engine_args(g, config, landmarks, loose: dict):
    """The resolved engine of one call, from ``config`` or from the loose
    keywords, never both (:meth:`EngineConfig.from_loose` is the gate).
    The loose keywords are the reference's: the engine knobs and any
    other :class:`EngineConfig` field, except ``use_kernel``, which the
    port has no use for (``TypeError``).  Explicit ``landmarks`` are ALT
    data: a loose config that passes them gets ``use_alt=True``."""
    unknown = sorted(set(loose) - (_CONFIG_FIELDS - {"use_kernel"}))
    if unknown:
        raise TypeError(f"unknown engine options {unknown}")
    if config is None and loose.get("p2p_mode") == "bidirectional" \
            and landmarks is None and not loose.get("use_alt"):
        raise ConfigError("p2p_mode='bidirectional' needs a landmark set "
                          "(use_alt=True / landmarks=...)")
    config = EngineConfig.from_loose(
        config, "engine",
        defaults=None if landmarks is None else {"use_alt": True}, **loose)
    return as_resolved(config, n=g.n, m=g.m).require("single")


def _check_layout_given_once(layout, loose: dict) -> None:
    if layout is not None and {"block_v", "tile_e"} & set(loose):
        raise ValueError("pass either layout= or layout options, not both")


def _solve_device(device, r) -> torch.device:
    """``device``, else the config's first pinned device, else ``cuda``."""
    if device is None and r.devices is not None:
        device = resolve_devices(r.devices)[0]
    return resolve_device(device)


def _prepare(g, r, device, sources, layout, landmarks, goal):
    """The common set-up of :func:`sssp` and :func:`sssp_batch`: the
    graph and the layout on the device, the sources checked, and the ALT
    data of a p2p solve (explicit ``landmarks`` win; a ``use_alt`` config
    without them builds a set with this solve's backend and layout)."""
    be = relax.get_backend(r.backend)
    dev = _solve_device(device, r)
    g = _on_device(g, dev)
    bad = [s for s in sources if not 0 <= int(s) < g.n]
    if bad:
        raise ValueError(f"source(s) {bad} out of range for n={g.n}")
    if layout is None:
        layout = be.prepare(g, **r.layout_opts())
    alt = None
    if goal == "p2p":
        if landmarks is None and r.use_alt:
            from .landmarks import build_landmarks
            landmarks = build_landmarks(
                g, r.n_landmarks, r.landmark_strategy, device=dev,
                backend=be, fused_rounds=r.fused_rounds, layout=layout)
        if landmarks is not None:
            alt = relax.AltData(*(t.to(dev) for t in
                                  getattr(landmarks, "alt_data", landmarks)))
        if r.p2p_mode == "bidirectional":
            if alt is None:
                raise ConfigError("p2p_mode='bidirectional' needs a landmark "
                                  "set (use_alt=True / landmarks=...)")
            if r.policy != "static" or r.trace_cap > 0:
                raise ConfigError("p2p_mode='bidirectional' supports only "
                                  "policy='static' without tracing")
    return be, g, layout, alt


def sssp(g, source, *, backend=None, layout=None, max_iters=None,
         alpha=None, beta=None, fused_rounds=None, policy=None,
         goal: str = "tree", goal_param=None, config=None, landmarks=None,
         device=None, **backend_opts):
    """Run the heuristic SSSP algorithm from ``source``.

    The single-device engine entry point; prefer the
    :class:`repro_torch.api.Solver` facade, which owns the layout and the
    landmarks.  ``g`` is a :class:`HostGraph` (moved to ``device``) or a
    :class:`DeviceGraph` already there.  ``device`` defaults to the
    config's pinned device, else ``cuda``; pass ``"cpu"`` to run without
    a card.  ``config`` (an :class:`EngineConfig` or a resolved one)
    replaces the loose keywords: ``backend`` (``"segment_min"`` or
    ``"blocked"``), ``alpha``/``beta``/``max_iters``, ``policy``
    (``"static"``/``"adaptive"``), ``fused_rounds`` (blocked only: up to
    that many rounds per call of the fused kernel) and the other config
    fields (``block_v``, ``tile_e``, ``p2p_mode``, ``use_alt``, ...); any
    other keyword raises ``TypeError``.  Pass a prebuilt ``layout`` to
    amortize the layout build.  ``goal``/``goal_param`` select an
    early-exit query (:data:`GOALS`).  ``landmarks`` (a
    :class:`~repro_torch.core.landmarks.LandmarkSet` or a raw
    :class:`~repro_torch.core.relax.AltData`) prunes p2p queries exactly
    and is ignored by the other goals; ``use_alt=True`` without it
    builds a set for the call; ``p2p_mode="bidirectional"`` (which needs
    landmarks) runs the meet-in-the-middle p2p solve.  Returns ``(dist,
    parent, metrics)`` as device tensors, or ``(dist, parent, metrics,
    trace_buf)`` when the config traces (``EngineConfig(trace=True)``:
    one record per loop iteration in a ring of ``trace_capacity``;
    :func:`repro_torch.obs.materialize_trace` copies it to the host).
    """
    loose = dict(backend_opts, backend=backend, max_iters=max_iters,
                 alpha=alpha, beta=beta, fused_rounds=fused_rounds,
                 policy=policy)
    loose = {k: v for k, v in loose.items() if v is not None}
    r = _engine_args(g, config, landmarks, loose)
    _check_layout_given_once(layout, loose)
    gp_host = goal_param_array(goal, goal_param)
    if gp_host.dim() != 0:
        raise ValueError(f"goal_param of one solve must be a scalar, got "
                         f"shape {tuple(gp_host.shape)}")
    _check_goal_bounds(goal, gp_host, g.n)
    be, g, layout, alt = _prepare(g, r, device, [source], layout, landmarks,
                                  goal)
    with profiling.annotate("repro:sssp_dispatch"):
        if goal == "p2p" and r.p2p_mode == "bidirectional":
            return _run_bidi(g, layout, int(source), int(gp_host), be,
                             r.max_iters, float(r.alpha), float(r.beta),
                             r.fused_rounds, alt)
        buf = trace_init(r.trace_cap, g.device) if r.trace_cap > 0 else None
        out = _run(g, layout, int(source), be, r.max_iters, float(r.alpha),
                   float(r.beta), r.fused_rounds, goal, gp_host.to(g.device),
                   alt, r.policy, buf)
    return out if buf is None else (*out, buf)


def _shim(name: str, replacement: str) -> None:
    warnings.warn(
        f"{name} is deprecated: open a solver session instead — "
        f"`repro_torch.api.Solver.open(g).solve({replacement})` (one "
        f"facade for every goal kind and backend)",
        FacadeDeprecationWarning, stacklevel=3)


def sssp_p2p(g, source, target, **kw):
    """Deprecated shim over the p2p goal (see :mod:`repro_torch.api`):
    ``dist[target]`` and its parent chain equal the full tree's."""
    _shim("sssp_p2p", "SolveSpec.p2p(source, target)")
    return sssp(g, source, goal="p2p", goal_param=target, **kw)


def sssp_bounded(g, source, bound, **kw):
    """Deprecated shim over the distance-bounded goal: every vertex with
    ``dist <= bound`` is settled (entries above it are tentative)."""
    _shim("sssp_bounded", "SolveSpec.bounded(source, bound)")
    return sssp(g, source, goal="bounded", goal_param=bound, **kw)


def sssp_knear(g, source, k, **kw):
    """Deprecated shim over the k-nearest goal: the source and its ``k``
    nearest vertices are settled (the rest tentative)."""
    _shim("sssp_knear", "SolveSpec.knear(source, k)")
    return sssp(g, source, goal="knear", goal_param=k, **kw)


# ---------------------------------------------------------------------------
# batched solves: a slot axis on the state
# ---------------------------------------------------------------------------

def _row(s: SsspState, i: int) -> SsspState:
    """Slot ``i`` of a stacked state, as views."""
    return SsspState(*(SsspMetrics(*(m[i] for m in x))
                       if isinstance(x, SsspMetrics) else x[i] for x in s))


def _set_row(s: SsspState, i: int, row: SsspState) -> None:
    """Write ``row`` into slot ``i`` of the stacked state, in place."""
    for x, y in zip(s, row):
        for a, b in (zip(x, y) if isinstance(x, SsspMetrics) else [(x, y)]):
            if a[i].data_ptr() != b.data_ptr():   # not already that row
                a[i] = b


def _clone(s: SsspState) -> SsspState:
    return SsspState(*(SsspMetrics(*(m.clone() for m in x))
                       if isinstance(x, SsspMetrics) else x.clone()
                       for x in s))


def _initial_states(n: int, sources: list, dev) -> SsspState:
    """The stacked ``[S, n]`` initial state of :func:`_initial_state`."""
    n_slots = len(sources)
    rows = torch.arange(n_slots, device=dev)
    src = torch.tensor(sources, dtype=torch.int64).to(dev)
    dist0 = torch.full((n_slots, n), INF, dtype=torch.float32, device=dev)
    dist0[rows, src] = 0.0
    parent0 = torch.full((n_slots, n), -1, dtype=torch.int32, device=dev)
    parent0[rows, src] = src.to(torch.int32)
    frontier0 = torch.zeros(n_slots, n, dtype=torch.bool, device=dev)
    frontier0[rows, src] = True
    zero = lambda dtype: torch.zeros(n_slots, dtype=dtype, device=dev)
    metrics0 = SsspMetrics(**{
        name: zero(torch.float32 if name in PHYSICAL_METRIC_FIELDS
                   else torch.int32) for name in SsspMetrics._fields})
    metrics0 = metrics0._replace(n_extended=metrics0.n_extended + 1)
    return SsspState(dist=dist0, parent=parent0, frontier=frontier0,
                     lb=zero(torch.float32),
                     ub=torch.full((n_slots,), INF, device=dev),
                     st=zero(torch.float32), done=zero(torch.bool),
                     metrics=metrics0)


def _slots(active: list, n_slots: int, dev) -> relax.Slots:
    """The :class:`relax.Slots` of the host list ``active``; the copy to
    the device does not wait for the stream."""
    ids = torch.tensor(active, dtype=torch.int32).to(dev, non_blocking=True)
    mask = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    return relax.Slots(mask=mask.index_fill_(0, ids.long(), True), ids=ids)


def _run_batch(g: DeviceGraph, layout, sources: list, backend, max_iters,
               alpha: float, beta: float, fused_rounds: int, goal: str, gp,
               alt, policy: str, buf: TraceBuf | None = None):
    """``len(sources)`` solves in one loop over a stacked ``[S, n]`` state.

    Each iteration relaxes every slot still running in one backend call
    (one batched launch of the one-round kernel on ``blocked``; with
    ``fused_rounds > 0`` one call of the fused kernel per slot), runs the
    bootstrap tightening on all of them, reads one ``[2, S]`` tensor
    (done, any frontier), and then runs the step transition of each slot
    whose frontier emptied, on its own row.  A slot whose previous
    transition finished it drops this iteration's round, as the one-slot
    loop does, and leaves the batch; so every slot's dist, parent and
    logical counters are its single solve's, bit for bit.  ``gp`` holds
    the per-slot goal parameters ``[S]`` on the device.  ``buf`` (a
    stacked ring, one per slot) gets a record for each slot that ran the
    iteration, as the reference's vmapped loop leaves a finished slot's
    ring as it was."""
    n_slots, dev = len(sources), g.device
    c = _consts(g.deg, alpha, beta)
    s = _initial_states(g.n, sources, dev)
    ps = stepping.policy_init(c.params, dev, (n_slots,)) \
        if policy == "adaptive" else None
    alt_lb = bound_of = None
    slot_alt = lambda i: {}
    if alt is not None:
        tgt = gp
        infl = 1.0 + 4.0 * alt.delta
        alt_lb = torch.stack([relax.alt_lower_bounds(alt.D, tgt[i],
                                                     alt.delta, alt.sym)
                              for i in range(n_slots)])
        src_t = torch.tensor(sources, dtype=torch.int32).to(dev)
        prune_ub = torch.stack([relax.alt_seed_ub(alt.D, src_t[i], tgt[i],
                                                  infl, alt.sym)
                                for i in range(n_slots)])
        bound_of = lambda dist: torch.minimum(
            prune_ub, dist.gather(1, tgt.long()[:, None])[:, 0] * infl)

        def slot_alt(i):
            bound = lambda dist: torch.minimum(
                prune_ub[i], relax.at(dist, tgt[i]) * infl)
            return dict(alt_lb=alt_lb[i], bound_of=bound,
                        fused=(alt_lb[i], prune_ub[i], infl, tgt[i]))

    def relax_step(s, active, slots):
        if fused_rounds <= 0:
            extra = () if alt is None else (alt_lb, bound_of(s.dist))
            return _relax_round(backend, layout, s, *extra, slots=slots)
        out = _clone(s)
        for i in active:
            fused_alt = slot_alt(i).get("fused", ())
            _set_row(out, i, _fused_relax_rounds(layout, _row(s, i),
                                                 fused_rounds, *fused_alt))
        return out

    active = list(range(n_slots))
    slots = _slots(active, n_slots, dev)
    syncs = [0] * n_slots
    for _ in range(max_iters):
        prev = s
        snap = None if buf is None else _trace_snap(s)
        s = relax_step(s, active, slots)
        s = _bootstrap_ub(g, s, c.high_d0)
        done, any_front = torch.stack([s.done, s.frontier.any(dim=1)]
                                      ).tolist()
        for i in active:
            syncs[i] += 1
        finished = [i for i in active if done[i]]
        if finished:
            # the previous transition finished these slots: their round
            # here ran on an empty frontier and is dropped
            for i in finished:
                _set_row(s, i, _row(prev, i))
            active = [i for i in active if not done[i]]
            if not active:
                break
            slots = _slots(active, n_slots, dev)
        for i in active:
            if any_front[i]:
                continue
            a = slot_alt(i)
            kw = dict(goal=goal, goal_param=gp[i],
                      alt_lb=a.get("alt_lb"), bound_of=a.get("bound_of"))
            if ps is None:
                _set_row(s, i, _transition(g, _row(s, i), c, **kw))
            else:
                row, ps_i = _transition(g, _row(s, i), c,
                                        ps=stepping.PolicyState(
                                            *(x[i] for x in ps)), **kw)
                # the counter snapshots are views of this slot's metrics:
                # take them before the row is overwritten
                for x, y in zip(ps, ps_i):
                    x[i] = y
                _set_row(s, i, row)
        if buf is not None:
            _trace_record(snap, s, buf, slots.ids.long())
    metrics = s.metrics._replace(n_host_syncs=torch.tensor(
        syncs, dtype=torch.float32).to(dev))
    return s.dist, s.parent, metrics


def sssp_batch(g, sources, *, backend=None, layout=None, max_iters=None,
               alpha=None, beta=None, fused_rounds=None, policy=None,
               goal: str = "tree", goal_params=None, config=None,
               landmarks=None, device=None, **backend_opts):
    """Batched multi-source SSSP: one solve loop over ``sources``.

    The per-source state (dist/parent/frontier/window) is stacked along
    a leading slot axis ``[S, n]`` on the device, over one shared layout.
    Each iteration relaxes all slots still running in one call of the
    backend: on ``segment_min`` one scatter over the flattened ``[S *
    n]`` destinations, on ``blocked`` one launch of the ``edge_relax``
    kernel over the active slots (counted in ``LAUNCHES.edge_relax_batch``
    or ``edge_relax_batch_alt``).  The loop reads one ``[2, S]`` flag
    tensor per iteration; each slot whose frontier emptied then runs its
    step transition on its own row, and a finished slot leaves the batch
    while the rest keep stepping.  So every slot's ``dist``, ``parent``
    and logical counters are bitwise those of :func:`sssp` from
    ``sources[i]`` with ``goal_params[i]`` (and the reference's
    ``sssp_batch``, whose vmapped loop freezes a finished slot).  A
    traced config adds a fourth output, a ring per slot (``[S, cap,
    cols]`` planes) that :func:`repro_torch.obs.materialize_trace` turns
    into one ``SolveTrace`` per slot.

    Two cases run slot by slot inside each iteration, with the same
    per-slot result: with ``fused_rounds > 0`` the fused kernel runs once
    per active slot, and a bidirectional p2p batch runs each slot's
    meet-in-the-middle solve in turn.

    All slots share the ``goal`` kind; ``goal_params`` holds one
    target / bound / k per source.  Options as in :func:`sssp`.  Returns
    ``(dist, parent, metrics)`` with a leading ``[S]`` axis.
    """
    loose = dict(backend_opts, backend=backend, max_iters=max_iters,
                 alpha=alpha, beta=beta, fused_rounds=fused_rounds,
                 policy=policy)
    loose = {k: v for k, v in loose.items() if v is not None}
    r = _engine_args(g, config, landmarks, loose)
    _check_layout_given_once(layout, loose)
    src = np.asarray(sources, np.int64)
    if src.ndim != 1 or src.size == 0:
        raise ValueError(f"sources must be a non-empty 1-D sequence, got "
                         f"shape {src.shape}")
    if goal == "tree" and goal_params is None:
        goal_params = [0] * src.shape[0]
    gp_host = goal_param_array(goal, goal_params)
    if tuple(gp_host.shape) != src.shape:
        raise ValueError(f"goal_params shape {tuple(gp_host.shape)} != "
                         f"sources shape {src.shape}")
    sources = src.tolist()
    _check_goal_bounds(goal, gp_host, g.n)
    be, g, layout, alt = _prepare(g, r, device, sources, layout, landmarks,
                                  goal)
    with profiling.annotate("repro:sssp_batch_dispatch"):
        if goal == "p2p" and r.p2p_mode == "bidirectional":
            outs = [_run_bidi(g, layout, s, int(t), be, r.max_iters,
                              float(r.alpha), float(r.beta), r.fused_rounds,
                              alt)
                    for s, t in zip(sources, gp_host.tolist())]
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]),
                    SsspMetrics(*(torch.stack(f) for f in
                                  zip(*(o[2] for o in outs)))))
        buf = trace_init(r.trace_cap, g.device, len(sources)) \
            if r.trace_cap > 0 else None
        out = _run_batch(g, layout, sources, be, r.max_iters, float(r.alpha),
                         float(r.beta), r.fused_rounds, goal,
                         gp_host.to(g.device), alt, r.policy, buf)
    return out if buf is None else (*out, buf)


def metrics_dict(metrics: SsspMetrics) -> dict:
    """Every ``SsspMetrics`` field as a host-side scalar: logical counters
    as ``int``, physical ones as ``float``."""
    return {name: (float if name in PHYSICAL_METRIC_FIELDS else int)(
        getattr(metrics, name).item()) for name in SsspMetrics._fields}


def normalized_metrics(g_deg, dist, metrics: SsspMetrics) -> dict:
    """Paper §4 normalizations: nFrontier, nSync, nTrav (host-side)."""
    deg = np.asarray(g_deg.cpu() if isinstance(g_deg, torch.Tensor)
                     else g_deg)
    d = np.asarray(dist.cpu() if isinstance(dist, torch.Tensor) else dist)
    m = metrics_dict(metrics)
    reach = np.isfinite(d)
    n_reach = max(int(reach.sum()), 1)
    nonleaf = max(int((reach & (deg > 1)).sum()), 1)
    logn = max(np.log2(max(deg.shape[0], 2)), 1.0)
    return {
        "nFrontier": m["n_extended"] / nonleaf,
        "nSync": m["n_rounds"] / logn,
        "nTrav": (m["n_trav"] + m["n_pull_trav"]) / n_reach,
        "nTrav_push": m["n_trav"] / n_reach,
        "nTrav_pull": m["n_pull_trav"] / n_reach,
        "n_steps": m["n_steps"],
        "n_rounds": m["n_rounds"],
        "n_relax": m["n_relax"],
        "n_updates": m["n_updates"],
        "n_pruned": m["n_pruned"],
        "n_tiles_scanned": int(m["n_tiles_scanned"]),
        "n_tiles_dense": int(m["n_tiles_dense"]),
        "n_invocations": int(m["n_invocations"]),
        "reachable": n_reach,
    }
