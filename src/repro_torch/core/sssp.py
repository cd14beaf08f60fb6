"""The heuristic SSSP algorithm (paper §3.3, Algorithm 2 + Function 1/2),
single device, static policy (port of ``repro.core.sssp``): the full tree,
the early-exit goals (p2p, bounded, knear) and ALT-pruned p2p queries,
unidirectional or bidirectional.

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
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import relax, stats, stepping, traversal
from .graph import DEFAULT_ALPHA, DEFAULT_BETA, DeviceGraph, HostGraph, \
    degree_bucket
from .relax import INF, INT_MAX, count

__all__ = ["sssp", "prepare_layout", "SsspMetrics", "LOGICAL_METRIC_FIELDS",
           "PHYSICAL_METRIC_FIELDS", "metrics_dict", "normalized_metrics",
           "GOALS", "P2P_MODES", "goal_param_array", "INF", "INT_MAX"]

# Early-exit query goals.  Each stops once its answer is settled (every
# vertex with dist < lb is final, relax.settled_mask):
#   "tree"    no goal: run until every reachable vertex settles;
#   "p2p"     stop once the target (the goal parameter) settles; its dist
#             and parent chain then equal the tree solve's bit for bit;
#   "bounded" stop once lb > D: every vertex with dist <= D is settled;
#   "knear"   stop once k + 1 vertices (the source and its k nearest) are.
GOALS = ("tree", "p2p", "bounded", "knear")
P2P_MODES = ("unidirectional", "bidirectional")


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
                 alt_lb=None, prune_bound=None) -> SsspState:
    """One synchronized round of push-model edge relaxations; with
    ``alt_lb``/``prune_bound`` (ALT p2p) the backend cuts candidates that
    cannot improve the target (:func:`relax.alt_prune`)."""
    extra = () if alt_lb is None else (alt_lb, prune_bound)
    new_dist, new_parent, rm = backend.relax_window(
        layout, st_.dist, st_.parent, st_.frontier, st_.lb, st_.ub, *extra)
    m = st_.metrics
    metrics = m._replace(
        n_rounds=m.n_rounds + st_.frontier.any().to(torch.int32),
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
    known path linking s to a vertex of degree >= highD(0)."""
    mask = (g.deg.to(torch.float32) >= high_d0) & (st_.dist > 0)
    cand = torch.where(mask, st_.dist, INF).min()
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
                bound_of=None) -> SsspState:
    """Step transition (Algo 2 l.22 + Function 1/2 + fast-forward and
    termination), static policy.

    ``min_pending(g, dist, ub)`` and ``pull_phase(g, dist, parent, st,
    lb, ub, metrics)`` are the two places that read edges; the sharded
    engine passes versions that run over its local slab and merge across
    ranks.  Everything else reads only ``g.deg``, ``g.rtow``,
    ``g.n_edges2`` and the state.  ``goal``/``goal_param`` end the solve
    once the goal settles; ``alt_lb`` with ``bound_of(dist)`` (the prune
    bound at this dist) cuts pending candidates and pull requests that
    cannot improve the p2p target."""
    dist, parent = st_.dist, st_.parent
    lb, ub = st_.lb, st_.ub
    alt = () if alt_lb is None else (alt_lb, bound_of(dist))

    # smallest pending candidate path length (>= ub); inf <=> done
    min_pending = min_pending(g, dist, ub, *alt)
    done = ~torch.isfinite(min_pending)

    st_next = traversal.compute_st(dist, g.deg, g.rtow, g.n_edges2, lb, ub,
                                   c.params, bucket=c.bucket,
                                   unit_grid=c.unit_grid)
    lb2 = ub
    gap2 = stepping.gap(dist, g.deg, g.rtow, g.n_edges2, lb2, c.params,
                        c.bucket)
    ub2 = lb2 + gap2
    # empty-window fast-forward (exact: no shortest path in the skip)
    ffwd = (min_pending >= ub2) & ~done
    lb2 = torch.where(ffwd, min_pending, lb2)
    gap3 = stepping.gap(dist, g.deg, g.rtow, g.n_edges2, lb2, c.params,
                        c.bucket)
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
    return st_._replace(dist=dist, parent=parent, frontier=frontier,
                        lb=lb2, ub=ub2, st=st_next, done=done,
                        metrics=metrics)


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


def _solve_loop(g, s: SsspState, c: _Consts, relax_step, transition,
                max_iters: int):
    """The stepping loop: a relaxation call, the bootstrap tightening, one
    host read of ``(done, any(frontier))``, and the step transition when
    the frontier is empty.  ``g`` needs ``deg``; returns ``(dist,
    parent, metrics)``."""
    syncs = 0
    for _ in range(max_iters):
        prev = s
        s = relax_step(s)
        s = _bootstrap_ub(g, s, c.high_d0)
        done, any_front = torch.stack([s.done, s.frontier.any()]).tolist()
        syncs += 1
        if done:
            # the previous transition finished the solve: this round ran
            # on an empty frontier and is dropped
            s = prev
            break
        if not any_front:
            s = transition(s)
    metrics = s.metrics._replace(n_host_syncs=torch.full(
        (), float(syncs), dtype=torch.float32, device=g.deg.device))
    return s.dist, s.parent, metrics


def _run(g: DeviceGraph, layout, source: int, backend: relax.RelaxBackend,
         max_iters: int, alpha: float, beta: float, fused_rounds: int = 0,
         goal: str = "tree", goal_param=None, alt=None):
    """One SSSP computation; returns ``(dist, parent, metrics)``.
    ``fused_rounds > 0`` (blocked layouts) relaxes through the fused
    kernel, up to that many rounds per call.  ``goal_param`` is a 0-d
    device tensor; ``alt`` (an :class:`relax.AltData`, p2p only) prunes
    with the landmark bounds toward the target."""
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
    return _solve_loop(g, s, c, relax_step,
                       lambda s: _transition(g, s, c, goal=goal,
                                             goal_param=goal_param,
                                             alt_lb=alt_lb,
                                             bound_of=bound_of), max_iters)


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
    return relax.get_backend(backend).prepare(g, **backend_opts)


_LATER = {
    "policy": "the adaptive-policy slice",
    "trace": "the observability slice",
    "config": "the config slice (core/config.py)",
}


def sssp(g, source, *, backend="segment_min", layout=None,
         max_iters=1_000_000, alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA,
         device=None, goal="tree", goal_param=None, fused_rounds=0,
         policy="static", trace=False, landmarks=None,
         p2p_mode="unidirectional", config=None, **layout_opts):
    """Run the heuristic SSSP algorithm from ``source``.

    ``g`` is a :class:`HostGraph` (moved to ``device``) or a
    :class:`DeviceGraph` already there.  ``device`` defaults to ``cuda``
    and must be given as ``"cpu"`` to run without a card.  ``backend``
    is ``"segment_min"`` or ``"blocked"``; ``layout_opts`` (``block_v``,
    ``tile_e``; any other keyword raises ``TypeError``) shape the blocked
    layout, or pass a prebuilt ``layout``.  ``fused_rounds > 0`` (blocked
    backend only) runs up to that many rounds per call of the fused
    kernel, with the same result.  ``goal``/``goal_param`` select an
    early-exit query (:data:`GOALS`).  ``landmarks`` (a
    :class:`~repro_torch.core.landmarks.LandmarkSet` or a raw
    :class:`~repro_torch.core.relax.AltData`) prunes p2p queries exactly
    and is ignored by the other goals; ``p2p_mode="bidirectional"`` (which
    needs landmarks) runs the meet-in-the-middle p2p solve, standing in
    for the reference's ``EngineConfig.p2p_mode``.  Returns ``(dist,
    parent, metrics)`` as device tensors.

    The adaptive policy, tracing and ``config=`` belong to later slices of
    the port and raise ``NotImplementedError``.
    """
    _check_layout_opts(layout_opts)
    asked = {"policy": policy != "static", "trace": bool(trace),
             "config": config is not None}
    for name, on in asked.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet; it comes "
                                      f"with {_LATER[name]}")
    be = relax.get_backend(backend)
    fused_rounds = int(fused_rounds)
    if fused_rounds < 0:
        raise ValueError(f"fused_rounds must be >= 0, got {fused_rounds}")
    if fused_rounds and be is not relax.BLOCKED_PALLAS:
        raise ValueError(f"fused_rounds needs the blocked backend, not "
                         f"{be.name!r} (set backend='blocked', or drop "
                         "fused_rounds)")
    if p2p_mode not in P2P_MODES:
        raise ValueError(f"unknown p2p_mode {p2p_mode!r}; expected one of "
                         f"{P2P_MODES}")
    gp_host = goal_param_array(goal, goal_param)
    alt = getattr(landmarks, "alt_data", landmarks) if goal == "p2p" \
        else None
    bidi = goal == "p2p" and p2p_mode == "bidirectional"
    if bidi and alt is None:
        raise ValueError("p2p_mode='bidirectional' needs a landmark set "
                         "(landmarks=...)")
    dev = resolve_device(device)
    g = _on_device(g, dev)
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source {source} out of range for n={g.n}")
    _check_goal_bounds(goal, gp_host, g.n)
    if alt is not None:
        alt = relax.AltData(*(t.to(dev) for t in alt))
    if layout is None:
        layout = be.prepare(g, **layout_opts)
    elif layout_opts:
        raise ValueError("pass either layout= or layout options, not both")
    if bidi:
        return _run_bidi(g, layout, int(source), int(gp_host), be,
                         max_iters, float(alpha), float(beta), fused_rounds,
                         alt)
    return _run(g, layout, int(source), be, max_iters, float(alpha),
                float(beta), fused_rounds, goal, gp_host.to(dev), alt)


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
