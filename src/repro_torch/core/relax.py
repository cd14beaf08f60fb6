"""Pluggable relaxation backends (port of ``repro.core.relax``).

The windowed edge relaxation is the algorithm's inner loop (paper Algo 2
l.8-17).  A backend is ``relax_window(layout, dist, parent, frontier, lb,
ub) -> (new_dist, new_parent, RoundMetrics)`` plus a ``prepare(graph,
**opts)`` that builds its layout once; the registry selects them by name.

``segment_min``
    The dense flat edge list: a masked ``scatter_reduce`` min over all
    edges, then a min-source-id winner pass.  Plain torch ops.

``blocked_pallas`` (alias ``blocked``)
    The :class:`~repro_torch.core.graph.BlockedGraph` layout driving the
    ``kernels/edge_relax`` kernel: one call per round over all slabs
    (the hand-written CUDA kernel on the card, its plain version on the
    CPU).  :func:`blocked_fused_rounds` runs up to ``fused_rounds`` of
    those rounds in one call of the fused kernel.
    :func:`blocked_shard_partials_fused` is the sharded engines' call: one
    round over a shard's slabs through the partials kernel.

Every backend resolves ties toward the smallest source id, so
``dist``/``parent`` and the logical counters are bitwise-identical across
backends and to the reference.  The physical counters (tiles,
invocations) describe each layout's own work.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from .f32math import fma
from .graph import BlockedGraph, DeviceGraph, build_blocked
from ..kernels.edge_relax.ops import relax_bucket, relax_fused, \
    relax_partials

INT_MAX = 2 ** 31 - 1
INF = float("inf")


class RoundMetrics(NamedTuple):
    """Per-round relaxation outcome (0-d device tensors besides
    ``improved``).  The logical counters are int32; the physical ones are
    float32, as in the reference."""
    improved: torch.Tensor         # [N] bool — vertices whose dist improved
    n_trav: torch.Tensor           # in-window edge touches (push)
    n_relax: torch.Tensor          # relaxations attempted
    n_updates: torch.Tensor        # successful dist improvements
    n_extended: torch.Tensor       # non-leaf dist improvements
    n_pruned: torch.Tensor         # candidates cut by the ALT bound
    n_tiles_scanned: torch.Tensor  # edge tiles actually run
    n_tiles_dense: torch.Tensor    # dense-grid tile cost
    n_invocations: torch.Tensor    # kernel launches


def count(mask: torch.Tensor) -> torch.Tensor:
    """Number of set entries as an int32 0-d tensor (the reference's
    counter width; ``torch.sum`` alone would give int64)."""
    return mask.sum().to(torch.int32)


# ---------------------------------------------------------------------------
# shared relaxation primitives
# ---------------------------------------------------------------------------

def leaf_pruned(frontier, dist, deg):
    """Algo 2 l.8: paths reaching a leaf are never extended."""
    return frontier & ((dist <= 0.0) | (deg > 1))


def edge_candidates(d_src, f_src, p_src, dst, w, lb, ub):
    """Algo 2 l.10-11: windowed candidate lengths over gathered edge values.

    Returns ``(cand, in_window, active)``; ``cand`` is +inf outside
    ``active``, which also excludes the relaxation back along the parent
    edge (it can never improve)."""
    cand_len = d_src + w
    in_window = f_src & (cand_len >= lb) & (cand_len < ub)
    active = in_window & (dst != p_src)
    return torch.where(active, cand_len, INF), in_window, active


def segment_partial_min(cand, seg, num_segments: int):
    """Per-destination min of candidates; +inf for an empty segment."""
    out = torch.full((num_segments,), INF, dtype=cand.dtype,
                     device=cand.device)
    return out.scatter_reduce_(0, seg, cand, "amin")


def winner_partial(cand, mask, ids, seg, best, num_segments: int):
    """Deterministic winner recovery: min ``ids`` among candidates that
    achieve ``best`` at their segment (INT_MAX where none)."""
    win = torch.where(mask & (cand <= best[seg]), ids, INT_MAX)
    out = torch.full((num_segments,), INT_MAX, dtype=win.dtype,
                     device=win.device)
    return out.scatter_reduce_(0, seg, win, "amin").to(torch.int32)


def segment_min_with_winner(cand, mask, ids, seg, num_segments: int):
    """The (min, argmin-by-min-id) segment reduction."""
    best = segment_partial_min(cand, seg, num_segments)
    return best, winner_partial(cand, mask, ids, seg, best, num_segments)


def apply_updates(dist, parent, best, winner, gate=None):
    """Commit improvements where ``best < dist`` (optionally gated)."""
    improved = best < dist
    if gate is not None:
        improved = improved & gate
    return (torch.where(improved, best, dist),
            torch.where(improved, winner, parent), improved)


def combine_block_partials(vals, wins):
    """Combine stacked (min, winner) partials over the leading axis with
    the min-value / min-id-on-tie rule."""
    best = vals.min(dim=0).values
    winner = torch.where(vals <= best[None, :], wins, INT_MAX) \
        .min(dim=0).values
    return best, winner


def window_frontier(dist, st, lb, ub, max_w):
    """Function 1's frontier: the push band [max(0, lb - maxW), st] plus
    the window occupants."""
    lb0 = torch.clamp(lb - max_w, min=0.0)
    return ((dist >= lb0) & (dist <= st)) | ((dist >= lb) & (dist < ub))


def settled_mask(dist, lb):
    """Vertices whose distance is final under the stepping invariant."""
    return dist < lb


def at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` as a 0-d tensor for a 0-d index tensor ``i``, with no host
    read (indexing with a 0-d tensor may read it back to the host)."""
    return x.index_select(0, i.reshape(1).long()).reshape(())


# ---------------------------------------------------------------------------
# ALT (A*, landmarks, triangle inequality) goal-directed pruning primitives
# ---------------------------------------------------------------------------
#
# With landmark distances D[l, v] = d(L_l, v), d(L,t) - d(L,v) <= d(v,t)
# bounds the remaining distance from below (and, on a symmetric graph,
# d(L,v) - d(L,t) too).  A p2p candidate whose length plus that bound
# exceeds the best known s->t length cannot improve d(s,t) and is dropped.
# The engine's distances, the landmark distances and the prune bound are
# each rounded f32 path sums, so the bounds are deflated by
# delta * (D[l,t] + D[l,v]) and the prune bound inflated by 1 + 4 delta
# (delta from the landmark set's hop bound): every candidate on the
# engine's own shortest path then survives, and d(s,t) and its parent
# chain stay bitwise equal to the unpruned solve.

def alt_lower_bounds(D, t, delta, sym):
    """Admissible per-vertex lower bounds ``lb[v] <~ d(v, t)``.

    ``D`` is the ``[L, N]`` f32 landmark distance matrix, ``t`` the target
    id (0-d tensor), ``delta`` the 0-d f32 slack factor and ``sym`` a 0-d
    f32 0/1 flag (1: the graph is symmetric and the reverse difference is
    admissible too).  Both distances infinite (inf - inf) gives 0; one of
    them infinite keeps the bound infinite (v and t in different parts of
    the landmark's reach).  The deflation ``diff - delta * (D + Dt)`` is
    one fused multiply-add, as the reference's compiled program forms it
    on the CPU: ``D + Dt`` rounds to f32, the product does not.
    """
    Dt = D.index_select(1, t.reshape(1).long())          # [L, 1]
    fwd = Dt - D
    rev = torch.where(sym > 0, D - Dt, -INF)
    diff = torch.maximum(fwd, rev)
    slack = fma(-delta, D + Dt, diff)
    adj = torch.where(torch.isinf(diff), diff, slack)
    adj = torch.where(torch.isnan(adj), 0.0, adj)
    return torch.clamp(adj, min=0.0).max(dim=0).values


def alt_seed_ub(D, source, t, infl, sym):
    """Landmark-seeded upper bound on d(source, t) on a symmetric graph:
    ``min_l D[l,s] + D[l,t]``, inflated by ``infl``; +inf when the graph
    is not symmetric or no landmark reaches both endpoints."""
    pick = lambda v: D.index_select(1, v.reshape(1).long())[:, 0]
    seed = (pick(source) + pick(t)).min() * infl
    return torch.where(sym > 0, seed, INF)


def alt_prune(cand, active, lb_dst, prune_bound):
    """Split ``active`` candidates by the ALT test: ``(kept, pruned)``,
    pruned where ``cand + lb[dst] > prune_bound`` (``cand`` is +inf
    outside ``active``, so inactive lanes land in neither)."""
    pruned = active & (cand + lb_dst > prune_bound)
    return active & ~pruned, pruned


class AltData(NamedTuple):
    """The ALT operands a p2p solve carries: ``D`` the ``[L, N]`` f32
    landmark distances, ``delta`` the 0-d f32 slack factor
    (``2^-24 * (2 H + 64)`` for hop bound ``H``) and ``sym`` a 0-d f32
    0/1 flag (1: symmetric graph, enabling the reverse difference and the
    seeded upper bound), all on the solve's device."""
    D: torch.Tensor
    delta: torch.Tensor
    sym: torch.Tensor


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RelaxBackend:
    """An implementation of the windowed relaxation hot path."""
    name: str
    prepare: Callable[..., Any]
    relax_window: Callable[..., Any]


_REGISTRY: dict = {}


def register_backend(backend: RelaxBackend, aliases=()) -> RelaxBackend:
    _REGISTRY[backend.name] = backend
    for alias in aliases:
        _REGISTRY[alias] = backend
    return backend


def available_backends() -> tuple:
    """Canonical backend names (aliases resolve but are not listed)."""
    return tuple(sorted({b.name for b in _REGISTRY.values()}))


def get_backend(name) -> RelaxBackend:
    if isinstance(name, RelaxBackend):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown relax backend {name!r}; available: "
            f"{available_backends()}") from None


# ---------------------------------------------------------------------------
# backend: segment_min (dense flat edge list)
# ---------------------------------------------------------------------------

def _segment_min_prepare(g: DeviceGraph, **_opts) -> DeviceGraph:
    return g            # the flat edge list is its own layout


def _segment_min_relax(g: DeviceGraph, dist, parent, frontier, lb, ub,
                       alt_lb=None, prune_bound=None):
    paths = leaf_pruned(frontier, dist, g.deg)
    cand, in_window, active = edge_candidates(
        dist[g.src], paths[g.src], parent[g.src], g.dst, g.w, lb, ub)
    n_pruned = torch.zeros((), dtype=torch.int32, device=dist.device)
    if alt_lb is not None:
        active, pruned = alt_prune(cand, active, alt_lb[g.dst], prune_bound)
        cand = torch.where(active, cand, INF)
        n_pruned = count(pruned)
    best, winner = segment_min_with_winner(cand, active, g.src, g.dst, g.n)
    new_dist, new_parent, improved = apply_updates(dist, parent, best,
                                                   winner)
    zero = torch.zeros((), dtype=torch.float32, device=dist.device)
    rm = RoundMetrics(
        improved=improved, n_trav=count(in_window), n_relax=count(active),
        n_updates=count(improved), n_extended=count(improved & (g.deg > 1)),
        n_pruned=n_pruned, n_tiles_scanned=zero, n_tiles_dense=zero,
        n_invocations=zero)
    return new_dist, new_parent, rm


SEGMENT_MIN = register_backend(RelaxBackend(
    name="segment_min", prepare=_segment_min_prepare,
    relax_window=_segment_min_relax))


# ---------------------------------------------------------------------------
# backend: blocked_pallas (BlockedGraph layout -> edge_relax kernel)
# ---------------------------------------------------------------------------

def _blocked_prepare(g, **opts) -> BlockedGraph:
    return build_blocked(g, **opts)


def _pad(x, n_out, value):
    pad = n_out - x.shape[0]
    return torch.cat([x, torch.full((pad,), value, dtype=x.dtype,
                                    device=x.device)]) if pad else x


def _blocked_relax(bg: BlockedGraph, dist, parent, frontier, lb, ub,
                   alt_lb=None, prune_bound=None):
    dist_p = _pad(dist, bg.n_out, INF)
    parent_p = _pad(parent, bg.n_out, -1)
    frontier_p = _pad(frontier, bg.n_out, False)
    paths = leaf_pruned(frontier_p, dist_p, bg.deg)
    alt_p = None if alt_lb is None else _pad(alt_lb, bg.n_out, INF)

    # one call over all source blocks' slabs (global source ids): the
    # per-block (min, min-id) partials of the reference combine by the
    # same rule, so the result is the same.  The call also counts the
    # traversal (in-window slots, those not back along the parent edge,
    # those the ALT cut drops) and the scheduled tiles, as the
    # reference's pass over every slot does.
    best, winner, cnt = relax_bucket(
        dist_p, paths, parent_p, bg.src, bg.dst, bg.w, bg.tile_first, lb,
        ub, alt_p, prune_bound, tile_e=bg.tile_e, n_out=bg.n_out,
        index=bg.index)
    n_trav, n_relax, n_tiles, n_pruned = cnt.unbind()

    new_dist, new_parent, improved = apply_updates(dist_p, parent_p, best,
                                                   winner)
    n = bg.n
    improved = improved[:n]
    rm = RoundMetrics(
        improved=improved, n_trav=n_trav, n_relax=n_relax,
        n_updates=count(improved),
        n_extended=count(improved & (bg.deg[:n] > 1)), n_pruned=n_pruned,
        n_tiles_scanned=n_tiles.to(torch.float32),
        n_tiles_dense=torch.full((), float(bg.dense_grid_tiles),
                                 dtype=torch.float32, device=dist.device),
        n_invocations=torch.ones((), dtype=torch.float32,
                                 device=dist.device))
    return new_dist[:n], new_parent[:n], rm


BLOCKED_PALLAS = register_backend(RelaxBackend(
    name="blocked_pallas", prepare=_blocked_prepare,
    relax_window=_blocked_relax), aliases=("blocked",))


# ---------------------------------------------------------------------------
# the fused multi-round kernel (kernels/edge_relax, edge_relax_fused)
# ---------------------------------------------------------------------------

def blocked_fused_rounds(bg: BlockedGraph, dist, parent, frontier, lb, ub,
                         *, fused_rounds: int, alt_lb=None, prune_ub=None,
                         prune_infl=None, prune_tgt=None):
    """Up to ``fused_rounds`` relaxation rounds in one kernel call.

    The fused twin of calling :func:`_blocked_relax` once per round until
    the window settles: the same dist/parent/frontier and logical
    counters, with the state kept on the device across rounds and the
    counters folded into the kernel.  Returns ``(dist, parent, frontier,
    counts)`` over the unpadded vertex range; ``counts`` is the kernel's
    int32 ``FUSED_COUNTERS`` vector.

    With ``alt_lb`` (ALT p2p) the kernel recomputes the prune bound at
    the start of every round as ``min(prune_ub, dist[prune_tgt] *
    prune_infl)`` from its resident dist, the bound the unfused path
    computes between calls, so the pruning and ``n_pruned`` stay equal.
    """
    if bg.n_pad != bg.n_out:
        raise ValueError(
            "the fused kernel needs a whole-graph blocked layout (source "
            f"range == destination range); got n_pad={bg.n_pad}, "
            f"n_out={bg.n_out}")
    n = bg.n
    dist2, parent2, front2, cnt = relax_fused(
        _pad(dist, bg.n_out, INF), _pad(parent, bg.n_out, -1),
        _pad(frontier, bg.n_out, False), bg.deg, bg.src, bg.dst, bg.w,
        bg.tile_first, lb, ub,
        None if alt_lb is None else _pad(alt_lb, bg.n_out, INF), prune_ub,
        prune_infl, prune_tgt, tile_e=bg.tile_e, fused_rounds=fused_rounds,
        index=bg.index)
    return dist2[:n], parent2[:n], front2[:n], cnt


# ---------------------------------------------------------------------------
# the sharded engines' partials kernel (kernels/edge_relax,
# edge_relax_partials)
# ---------------------------------------------------------------------------

def blocked_shard_partials_fused(src, dst, w, tile_first, dist_src,
                                 paths_src, parent_src, src_base: int, lb,
                                 ub, *, tile_e: int, n_out: int, index=None,
                                 alt_lb=None, prune_bound=None):
    """One relaxation round over all of a shard's slabs in one kernel call.

    ``src`` (shard-local ids, the slabs' offsets already added), ``dst``,
    ``w`` and ``tile_first`` are the shard's concatenated slabs;
    ``dist_src``/``paths_src``/``parent_src`` its slice of the replicated
    state; ``index`` its :class:`~repro_torch.core.graph.TileIndex`
    (needed on the card).  With ``alt_lb`` (f32 ``[n_out]``) and
    ``prune_bound`` (0-d f32) the kernel cuts candidates that cannot
    improve the p2p target (its ALT branch).  Returns ``(best, winner,
    n_tiles, n_trav, n_relax, n_pruned)`` over ``n_out`` destinations,
    with *global* winner ids
    (``src_base`` added, ``INT_MAX`` kept); the counters are 0-d int32
    device tensors.
    """
    best, win_local, cnt = relax_partials(
        dist_src, paths_src, parent_src, src, dst, w, tile_first, lb, ub,
        alt_lb, prune_bound, tile_e=tile_e, n_out=n_out, index=index)
    winner = torch.where(win_local == INT_MAX, win_local,
                         win_local + src_base)
    return best, winner, cnt[2], cnt[0], cnt[1], cnt[3]
