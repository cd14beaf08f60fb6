"""The heuristic SSSP algorithm (paper §3.3, Algorithm 2 + Function 1/2),
single device, tree goal, static policy (port of ``repro.core.sssp``).

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
branched on.  ``n_host_syncs`` counts the reads.
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
           "INF", "INT_MAX"]


class SsspMetrics(NamedTuple):
    n_rounds: torch.Tensor      # synchronized relaxation rounds ("nSync" raw)
    n_steps: torch.Tensor       # scheduling-threshold pairs constructed
    n_extended: torch.Tensor    # extended paths ("nFrontier" raw)
    n_trav: torch.Tensor        # edge traversals, push model
    n_pull_trav: torch.Tensor   # edge traversals, pull model (requests)
    n_relax: torch.Tensor       # relaxation attempts (created paths)
    n_updates: torch.Tensor     # successful relaxations (dist improvements)
    n_pruned: torch.Tensor      # ALT cuts (no ALT in this port yet: 0)
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


def _relax_round(backend: relax.RelaxBackend, layout,
                 st_: SsspState) -> SsspState:
    """One synchronized round of push-model edge relaxations."""
    new_dist, new_parent, rm = backend.relax_window(
        layout, st_.dist, st_.parent, st_.frontier, st_.lb, st_.ub)
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


def _fused_relax_rounds(bg, st_: SsspState, fused_rounds: int) -> SsspState:
    """Up to ``fused_rounds`` synchronized rounds in one call of the fused
    kernel: the twin of calling :func:`_relax_round` once per round until
    the window settles, with the same dist/parent/frontier and logical
    counters."""
    new_dist, new_parent, new_front, cnt = relax.blocked_fused_rounds(
        bg, st_.dist, st_.parent, st_.frontier, st_.lb, st_.ub,
        fused_rounds=fused_rounds)
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


def _min_pending(g: DeviceGraph, dist, ub):
    """Smallest candidate path length at or above ``ub`` (inf if none)."""
    pend = dist[g.src] + g.w
    return torch.where(pend >= ub, pend, INF).min()


def _pull_phase(g: DeviceGraph, dist, parent, st, lb, ub, metrics):
    """Function 1's pull phase: settled band [st, lb) answers requests from
    unsettled vertices.  Returns the updated state and the metrics."""
    dv = dist[g.dst]
    # edges a pull scan touches: requester unsettled, weight short enough
    scan = (dist[g.src] > lb) & (g.w < ub - st)
    # requests created (responder side; w < ub - st is implied)
    mask = (dv >= st) & (dv < lb) & (dv + g.w < ub)
    cand = torch.where(mask, dv + g.w, INF)
    best, winner = relax.segment_min_with_winner(cand, mask, g.dst, g.src,
                                                 g.n)
    new_dist, new_parent, improved = relax.apply_updates(
        dist, parent, best, winner, gate=dist > lb)
    metrics = metrics._replace(
        n_pull_trav=metrics.n_pull_trav + count(scan),
        n_extended=metrics.n_extended + count(improved & (g.deg > 1)),
        n_relax=metrics.n_relax + count(mask),
        n_updates=metrics.n_updates + count(improved),
        n_rounds=metrics.n_rounds + 1)      # the pull phase is a round/sync
    return new_dist, new_parent, metrics


def _transition(g: DeviceGraph, st_: SsspState, c: _Consts,
                min_pending=_min_pending,
                pull_phase=_pull_phase) -> SsspState:
    """Step transition (Algo 2 l.22 + Function 1/2 + fast-forward and
    termination), tree goal, static policy.

    ``min_pending(g, dist, ub)`` and ``pull_phase(g, dist, parent, st,
    lb, ub, metrics)`` are the two places that read edges; the sharded
    engine passes versions that run over its local slab and merge across
    ranks.  Everything else reads only ``g.deg``, ``g.rtow``,
    ``g.n_edges2`` and the state."""
    dist, parent = st_.dist, st_.parent
    lb, ub = st_.lb, st_.ub

    # smallest pending candidate path length (>= ub); inf <=> done
    min_pending = min_pending(g, dist, ub)
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
                                       st_.metrics)
    dist = torch.where(pull, p_dist, dist)
    parent = torch.where(pull, p_parent, parent)
    metrics = SsspMetrics(*[torch.where(pull, a, b)
                            for a, b in zip(p_m, st_.metrics)])

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
         max_iters: int, alpha: float, beta: float, fused_rounds: int = 0):
    """One SSSP computation; returns ``(dist, parent, metrics)``.
    ``fused_rounds > 0`` (blocked layouts) relaxes through the fused
    kernel, up to that many rounds per call."""
    c = _consts(g.deg, alpha, beta)
    s = _initial_state(g.n, source, g.device)
    if fused_rounds > 0:
        relax_step = lambda s: _fused_relax_rounds(layout, s, fused_rounds)
    else:
        relax_step = lambda s: _relax_round(backend, layout, s)
    return _solve_loop(g, s, c, relax_step,
                       lambda s: _transition(g, s, c), max_iters)


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


def prepare_layout(g, backend="segment_min", *, device=None,
                   **backend_opts):
    """Build a backend's graph layout once (host-side preprocessing)."""
    g = _on_device(g, resolve_device(device))
    return relax.get_backend(backend).prepare(g, **backend_opts)


_LATER = {
    "goal": "the query-goal slice (p2p, bounded, knear)",
    "policy": "the adaptive-policy slice",
    "trace": "the observability slice",
    "landmarks": "the ALT slice",
}


def sssp(g, source, *, backend="segment_min", layout=None,
         max_iters=1_000_000, alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA,
         device=None, goal="tree", fused_rounds=0, policy="static",
         trace=False, landmarks=None, **layout_opts):
    """Run the heuristic SSSP algorithm from ``source`` (full tree).

    ``g`` is a :class:`HostGraph` (moved to ``device``) or a
    :class:`DeviceGraph` already there.  ``device`` defaults to ``cuda``
    and must be given as ``"cpu"`` to run without a card.  ``backend``
    is ``"segment_min"`` or ``"blocked"``; ``layout_opts`` (``block_v``,
    ``tile_e``) shape the blocked layout, or pass a prebuilt ``layout``.
    ``fused_rounds > 0`` (blocked backend only) runs up to that many
    rounds per call of the fused kernel, with the same result.
    Returns ``(dist, parent, metrics)`` as device tensors.

    The other query goals, the adaptive policy, tracing and ALT landmarks
    belong to later slices of the port and raise ``NotImplementedError``.
    """
    asked = {"goal": goal != "tree", "policy": policy != "static",
             "trace": bool(trace), "landmarks": landmarks is not None}
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
    dev = resolve_device(device)
    g = _on_device(g, dev)
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source {source} out of range for n={g.n}")
    if layout is None:
        layout = be.prepare(g, **layout_opts)
    elif layout_opts:
        raise ValueError("pass either layout= or layout options, not both")
    return _run(g, layout, int(source), be, max_iters, float(alpha),
                float(beta), fused_rounds)


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
