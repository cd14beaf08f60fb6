"""Sharded SSSP over ``torch.distributed``: the v1 engine (port of
``repro.core.distributed``).

**v1, replicated dist / all-reduce-min** (the paper-faithful engine).
``dist``/``parent`` are replicated on every rank; the edges are
partitioned by the owner of their source (rank ``q`` owns the vertex
block ``[q*B, (q+1)*B)``).  Each round every rank relaxes its own edges
into per-destination ``(min, winner)`` partials over the whole padded
vertex range, and one ``all_reduce(MIN)`` merges them: the pair travels
as one int64 key, ``bits(value) << 32 | global winner``.  Candidates are
non-negative or +inf, so the key orders by value, then by id, which is
the reference's two ``pmin``s (value, then the winner among the ranks
whose partial equals it) in one collective.  The counters are one
``all_reduce(SUM)``; ``deg`` is gathered once per solve.

The step transition is the single-device one (:mod:`.sssp`), given the
two places where v1 differs: the smallest pending candidate is reduced
across ranks, and the pull phase runs over the local slab (a mirrored
push; the graph stores both directions) with the same merge.  Every
loop decision is taken from replicated state after the collectives, so
all ranks leave the loop together.

Queries (``goal=``): ``p2p``, ``bounded`` and ``knear`` stop as the
single-device ones do; the goal test runs on the replicated ``dist``
after the pull phase.  A p2p query with ``landmarks`` prunes with ALT:
the per-vertex bound toward the target, padded with +inf to the padded
vertex range, and a prune bound ``min(seed, dist[t] * infl)`` taken from
``dist`` at the start of each round and each transition.  It cuts the
round's candidates (in the partials kernel on ``blocked``, with
:func:`relax.alt_prune` on ``segment_min``), the pending candidates of
the fast-forward, and the pull phase's requests, on ``lb[dst]``: in the
mirrored push the requester that receives the update is the
destination.

Per-shard backends (``backend=``): ``segment_min`` relaxes the flat
local slab in plain torch; ``blocked`` relaxes the shard's
:class:`~repro_torch.core.graph.ShardSlice` slabs through one
``edge_relax_partials`` call per round (the CUDA kernel on the card, its
plain version on the CPU; with ALT, its ALT branch).  Both give the
same ``dist``/``parent`` and logical counters as the single-device
engine.

The layouts (:class:`ShardedGraph`, :class:`BlockedShards`) are built on
the host in numpy, for every shard; each rank moves only its own shard
to its device.  ``trace=True`` records one replicated
:mod:`~repro_torch.obs.trace` record per loop iteration, and
:func:`repair_distributed` re-relaxes a repaired state after an edge
delta (:mod:`repro_torch.delta`) with the v1 round and merge.  v2/v3,
batches, the adaptive policy and ``config=`` come with later slices and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from . import relax
from . import sssp as single
from ..obs import profiling
from ..obs.trace import trace_init
from .graph import (DEFAULT_ALPHA, DEFAULT_BETA, HostGraph, TileIndex,
                    shard_block_v, shard_geometry, slice_for_shard)
from .relax import INF, count
from .sssp import (SsspMetrics, SsspState, _check_goal_bounds,
                   goal_param_array, resolve_device)

__all__ = ["ShardedGraph", "shard_graph", "BlockedShards",
           "BlockedShardMeta", "shard_blocked", "stack_tile_index",
           "DIST_BACKENDS",
           "sssp_distributed", "sssp_distributed_batch",
           "repair_distributed"]

DIST_BACKENDS = ("segment_min", "blocked")

_LATER = {
    "version": "the v2/v3 slice (ROADMAP queue 1 item 10: block-sharded "
               "state, the all_to_all exchange, fused_rounds grouping)",
    "batch": "the v2/v3 slice (ROADMAP queue 1 item 10), with batched "
             "solves",
    "repair": "the v2/v3 slice (ROADMAP queue 1 item 10); version='v1' "
              "repairs",
    "policy": "the adaptive-policy slice",
    "config": "the config and facade slice",
}


def _later(name: str):
    return NotImplementedError(f"{name} is not ported yet; it comes with "
                               f"{_LATER[name]}")


# ---------------------------------------------------------------------------
# host-side layouts (numpy, every shard)
# ---------------------------------------------------------------------------

class ShardedGraph(NamedTuple):
    """Edge slabs partitioned by source owner, plus the weight statistics
    every rank needs (numpy, host).

    ``src``/``dst``/``w`` are ``[P, E_max]`` (ragged slabs padded with
    ``w=+inf`` edges from the shard's first vertex); ``deg`` is ``[P, B]``,
    each shard's owner block, 0 past the true vertex count.
    """
    src: np.ndarray        # [P, E_max] int32 global source id
    dst: np.ndarray        # [P, E_max] int32 global destination id
    w: np.ndarray          # [P, E_max] float32 (+inf padding)
    deg: np.ndarray        # [P, B] int32
    rtow: np.ndarray       # [RATIO_NUM] float32
    n_edges2: int          # 2|E|, the directed slot count
    n_true: int            # real vertex count (pre-padding)


def shard_graph(g: HostGraph, n_shards: int) -> ShardedGraph:
    """Block vertex ownership, edges by source owner (host, numpy)."""
    p = n_shards
    block = -(-g.n // p)
    n_pad = block * p
    owner = g.src // block
    order = np.argsort(owner, kind="stable")
    src, dst, w = g.src[order], g.dst[order], g.w[order]
    counts = np.bincount(owner, minlength=p)
    e_max = max(int(counts.max()), 1)
    s_sl = np.repeat((np.arange(p) * block).astype(np.int32)[:, None],
                     e_max, axis=1)
    d_sl = np.zeros((p, e_max), np.int32)
    w_sl = np.full((p, e_max), np.inf, np.float32)
    offs = np.concatenate([[0], np.cumsum(counts)])
    for q in range(p):
        c = counts[q]
        s_sl[q, :c] = src[offs[q]:offs[q] + c]
        d_sl[q, :c] = dst[offs[q]:offs[q] + c]
        w_sl[q, :c] = w[offs[q]:offs[q] + c]
    deg = np.zeros(n_pad, np.int32)
    deg[:g.n] = g.deg
    return ShardedGraph(src=s_sl, dst=d_sl, w=w_sl,
                        deg=deg.reshape(p, block),
                        rtow=np.asarray(g.rtow, np.float32),
                        n_edges2=int(g.m), n_true=int(g.n))


class BlockedShards(NamedTuple):
    """Every shard's :class:`~repro_torch.core.graph.ShardSlice`, stacked
    (numpy, host).  The reference stacks ``[P, S, NT*tile_e]`` slabs with
    block-local source ids; here each shard's ``S`` slabs are stored
    concatenated with the slab offsets already added, so ``src`` holds
    shard-local ids in ``[0, B)`` and one kernel call covers the shard.
    Every slab has the same ``NT`` tiles.
    """
    src: np.ndarray              # [P, S*NT*tile_e] int32 shard-local src
    dst: np.ndarray              # [P, S*NT*tile_e] int32 global dst id
    w: np.ndarray                # [P, S*NT*tile_e] f32 (+inf padding)
    tile_dst: np.ndarray         # [P, S*NT] int32 dst block per tile
    tile_first: np.ndarray       # [P, S*NT] bool forced first tiles
    bucket_nonempty: np.ndarray  # [P, S, NB] bool bucket has edges
    # each shard's TileIndex over its local sources (stack_tile_index)
    vt_ptr: np.ndarray           # [P, B+1] int32
    vt_tile: np.ndarray          # [P, max entries] int32, 0-padded
    forced: np.ndarray           # [P, max forced] int32, tile 0 repeated


@dataclasses.dataclass(frozen=True)
class BlockedShardMeta:
    """Static geometry of a :class:`BlockedShards` layout."""
    block_v: int
    tile_e: int
    n_src_blocks: int            # S, source blocks per shard
    n_dst_blocks: int            # NB, destination blocks (global range)
    dense_grid_tiles: int        # global per-round cost of the dense scan


def stack_tile_index(indexes) -> TileIndex:
    """The shards' :class:`~repro_torch.core.graph.TileIndex` arrays
    stacked ``[P, ...]``.  ``vt_tile`` is padded with zeros, which no
    ``vt_ptr`` range reaches; ``forced`` with tile 0, which is forced in
    every shard (its first slab's first tile), so a repeat adds no tile
    to the schedule."""
    pad = lambda arrays: np.stack([np.pad(a, (0, max(map(len, arrays))
                                              - len(a))) for a in arrays])
    return TileIndex(vt_ptr=np.stack([ix.vt_ptr for ix in indexes]),
                     vt_tile=pad([ix.vt_tile for ix in indexes]),
                     forced=pad([ix.forced for ix in indexes]))


def _flat_edges(sg: ShardedGraph):
    """The real edges of a :class:`ShardedGraph` as a flat graph view."""
    w = sg.w.reshape(-1)
    real = np.isfinite(w)                       # padding carries w=inf
    return SimpleNamespace(src=sg.src.reshape(-1)[real],
                           dst=sg.dst.reshape(-1)[real], w=w[real],
                           deg=sg.deg.reshape(-1)[:sg.n_true])


def shard_blocked(g, n_shards: Optional[int] = None, *,
                  block_v: Optional[int] = None,
                  tile_e: Optional[int] = None,
                  device=None) -> Tuple[BlockedShards, BlockedShardMeta]:
    """Build every shard's blocked layout, stacked (host, numpy).

    ``g`` is a :class:`HostGraph` (with ``n_shards``) or a
    :class:`ShardedGraph` (its shard count).  ``block_v``/``tile_e`` left
    out follow :func:`~repro_torch.core.graph.shard_geometry` for
    ``device`` (default ``cuda``: one source block per shard and
    256-slot tiles; ``cpu``: the reference's 512/512).  Every slab is
    padded to the largest slab's tile count, sized by one counting pass.
    """
    if isinstance(g, ShardedGraph):
        if n_shards is None:
            n_shards = int(g.src.shape[0])
        g = _flat_edges(g)
    elif n_shards is None:
        raise ValueError("n_shards is required for a HostGraph")
    n = int(np.asarray(g.deg).shape[0])
    block = -(-n // n_shards)
    auto_v, auto_e = shard_geometry(block, "cuda" if device is None
                                    else device)
    block_v = auto_v if block_v is None else block_v
    tile_e = auto_e if tile_e is None else tile_e
    bv = shard_block_v(block, block_v)
    n_dst = block * n_shards // bv
    key = (np.asarray(g.src) // bv).astype(np.int64) * n_dst \
        + np.asarray(g.dst) // bv
    counts = np.bincount(key, minlength=n_dst * n_dst)
    nt = max(int((-(-counts.reshape(-1, n_dst) // tile_e)).sum(1).max()), 1)
    slices = [slice_for_shard(g, q, n_shards, block_v=bv, tile_e=tile_e,
                              n_tiles=nt) for q in range(n_shards)]
    arrays = BlockedShards(
        **{f: np.stack([getattr(sl, f) for sl in slices])
           for f in BlockedShards._fields if f not in TileIndex._fields},
        **stack_tile_index([sl.index for sl in slices])._asdict())
    meta = BlockedShardMeta(
        block_v=bv, tile_e=tile_e, n_src_blocks=slices[0].n_blocks,
        n_dst_blocks=slices[0].n_dst_blocks,
        dense_grid_tiles=sum(sl.dense_grid_tiles for sl in slices))
    return arrays, meta


def _resolve_backend(backend: str) -> str:
    if backend == "blocked_pallas":      # the single-device layout's name
        backend = "blocked"
    if backend not in DIST_BACKENDS:
        raise ValueError(f"unknown distributed relax backend {backend!r}; "
                         f"expected one of {DIST_BACKENDS}")
    return backend


def _resolve_blocked(sg: ShardedGraph, backend: str, blocked, device,
                     block_v, tile_e):
    """The (arrays, meta) pair the engine relaxes with, or ``None`` for
    ``segment_min``."""
    layout_opts = block_v is not None or tile_e is not None
    if _resolve_backend(backend) == "segment_min":
        if blocked is not None or layout_opts:
            raise ValueError("a blocked layout (blocked=, block_v=, "
                             "tile_e=) passed with backend='segment_min'")
        return None
    if blocked is None:
        # a one-off build; callers that solve repeatedly build once
        return shard_blocked(sg, block_v=block_v, tile_e=tile_e,
                             device=device)
    if layout_opts:
        raise ValueError("pass either blocked= or block_v/tile_e, not both")
    if blocked[0].src.shape[0] != sg.src.shape[0]:
        raise ValueError(f"blocked layout has {blocked[0].src.shape[0]} "
                         f"shards, graph has {sg.src.shape[0]}")
    return blocked


# ---------------------------------------------------------------------------
# one rank's view of the graph, on its device
# ---------------------------------------------------------------------------

class _ShardView(NamedTuple):
    """What the v1 loop reads of the graph on one rank: the local edge
    slab (global ids, int64 for indexing) and the replicated vertex
    arrays, with the collective group.  It stands in for a
    ``DeviceGraph`` in the single-device transition."""
    src: torch.Tensor        # [E_max] int64
    dst: torch.Tensor        # [E_max] int64
    w: torch.Tensor          # [E_max] float32
    deg: torch.Tensor        # [n_pad] int32, gathered once
    rtow: torch.Tensor
    n_edges2: torch.Tensor
    group: object

    @property
    def n(self) -> int:
        return self.deg.shape[0]


class _DeviceSlabs(NamedTuple):
    """One rank's blocked slabs on its device."""
    src: torch.Tensor        # shard-local ids
    dst: torch.Tensor
    w: torch.Tensor
    tile_first: torch.Tensor
    index: TileIndex         # over the shard's local sources
    base: int                # global id of the shard's first source
    block: int
    tile_e: int
    dense_grid_tiles: int


def _merge_partials(val, win, group):
    """Merge per-rank ``(min, winner)`` partials in one
    ``all_reduce(MIN)`` of ``bits(val) << 32 | win``: the minimum value,
    and the smallest winner among the ranks that reach it."""
    key = (val.view(torch.int32).to(torch.int64) << 32) | win.to(torch.int64)
    tdist.all_reduce(key, op=tdist.ReduceOp.MIN, group=group)
    return ((key >> 32).to(torch.int32).view(torch.float32),
            (key & 0xFFFFFFFF).to(torch.int32))


def _sum(counts, group):
    tdist.all_reduce(counts, op=tdist.ReduceOp.SUM, group=group)
    return counts


class _AltCtx(NamedTuple):
    """One ALT p2p query's pruning operands, replicated on every rank
    and fixed for the solve."""
    lb: torch.Tensor         # [n_pad] f32 lower bound to the target
    seed: torch.Tensor       # 0-d f32 landmark-seeded bound on d(s, t)
    infl: torch.Tensor       # 0-d f32 prune-bound inflation (1 + 4 delta)
    tgt: torch.Tensor        # 0-d int32 target

    def bound(self, dist):
        """The prune bound at ``dist``: the best known s-t length,
        inflated, capped by the seed (a 0-d device tensor, no read)."""
        return torch.minimum(self.seed, relax.at(dist, self.tgt) * self.infl)


def _make_alt_ctx(alt: relax.AltData, source: int, tgt, n_pad: int):
    """The :class:`_AltCtx` of one (source, target) query; the bound
    vector is padded with +inf so that the padding vertices, which hold
    no real edges, index safely."""
    infl = 1.0 + 4.0 * alt.delta
    lb = relax.alt_lower_bounds(alt.D, tgt, alt.delta, alt.sym)
    lb = torch.cat([lb, torch.full((n_pad - lb.shape[0],), INF,
                                   dtype=lb.dtype, device=lb.device)])
    src_t = torch.tensor(source, dtype=torch.int32, device=lb.device)
    seed = relax.alt_seed_ub(alt.D, src_t, tgt, infl, alt.sym)
    return _AltCtx(lb=lb, seed=seed, infl=infl, tgt=tgt)


# ---------------------------------------------------------------------------
# v1
# ---------------------------------------------------------------------------

def _v1_relax_round(view: _ShardView, slabs: Optional[_DeviceSlabs],
                    st_: SsspState, ac: Optional[_AltCtx] = None
                    ) -> SsspState:
    """One synchronized round: local partials, one merge, one counter
    sum, and the replicated commit.  With ``ac`` (ALT p2p) candidates
    that cannot improve the target are cut, at the prune bound of the
    round's starting ``dist``."""
    dist, parent, frontier = st_.dist, st_.parent, st_.frontier
    n_pad = view.n
    paths = relax.leaf_pruned(frontier, dist, view.deg)
    zero = torch.zeros((), dtype=torch.int32, device=dist.device)
    pb = None if ac is None else ac.bound(dist)
    if slabs is None:
        src, dst = view.src, view.dst
        cand, in_window, active = relax.edge_candidates(
            dist[src], paths[src], parent[src], dst, view.w, st_.lb, st_.ub)
        prn = zero
        if ac is not None:
            active, pruned = relax.alt_prune(cand, active, ac.lb[dst], pb)
            cand = torch.where(active, cand, INF)
            prn = count(pruned)
        best_l = relax.segment_partial_min(cand, dst, n_pad)
        win_l = relax.winner_partial(cand, active, src, dst, best_l, n_pad)
        # n_trav, n_relax, n_tiles, n_pruned, n_invocations
        counts = torch.stack([count(in_window), count(active), zero, prn,
                              zero])
        dense = 0
    else:
        lo, hi = slabs.base, slabs.base + slabs.block
        best_l, win_l, n_tiles, trav, rlx, prn = \
            relax.blocked_shard_partials_fused(
                slabs.src, slabs.dst, slabs.w, slabs.tile_first,
                dist[lo:hi], paths[lo:hi], parent[lo:hi], slabs.base,
                st_.lb, st_.ub, tile_e=slabs.tile_e, n_out=n_pad,
                index=slabs.index, alt_lb=None if ac is None else ac.lb,
                prune_bound=pb)
        counts = torch.stack([trav, rlx, n_tiles, prn, zero + 1])
        dense = slabs.dense_grid_tiles
    best, winner = _merge_partials(best_l, win_l, view.group)
    counts = _sum(counts, view.group)
    new_dist, new_parent, improved = relax.apply_updates(dist, parent, best,
                                                         winner)
    m = st_.metrics
    metrics = m._replace(
        n_rounds=m.n_rounds + frontier.any().to(torch.int32),
        n_extended=m.n_extended + count(improved & (view.deg > 1)),
        n_trav=m.n_trav + counts[0],
        n_relax=m.n_relax + counts[1],
        n_updates=m.n_updates + count(improved),
        n_pruned=m.n_pruned + counts[3],
        n_tiles_scanned=m.n_tiles_scanned + counts[2].to(torch.float32),
        n_tiles_dense=m.n_tiles_dense + float(dense),
        n_invocations=m.n_invocations + counts[4].to(torch.float32))
    return st_._replace(dist=new_dist, parent=new_parent, frontier=improved,
                        metrics=metrics)


def _v1_min_pending(view: _ShardView, dist, ub, alt_lb=None, bound=None):
    """The smallest pending candidate over every rank's slab; with ALT,
    less the ones the bound cuts (on ``alt_lb[dst]``)."""
    local = single._min_pending(view, dist, ub, alt_lb, bound).reshape(1)
    tdist.all_reduce(local, op=tdist.ReduceOp.MIN, group=view.group)
    return local.reshape(())


def _v1_pull_phase(view: _ShardView, dist, parent, st, lb, ub,
                   metrics: SsspMetrics, alt_lb=None, prune_bound=None):
    """Function 1's pull phase as a mirrored push from the settled band
    over the local slab (the responder is the owned source, the
    requester the destination), merged across ranks.  With ALT the
    requester receiving the update is ``dst``, so requests with ``cand +
    alt_lb[dst] > prune_bound`` are cut (the single-device phase cuts on
    ``alt_lb[src]``, its requester; the directed edges pair up one to
    one, so the counts agree)."""
    src, dst, w = view.src, view.dst, view.w
    dv = dist[src]
    mask = (dv >= st) & (dv < lb) & (dv + w < ub)
    cand = torch.where(mask, dv + w, INF)
    n_pruned = torch.zeros((), dtype=torch.int32, device=dist.device)
    if alt_lb is not None:
        mask, pruned = relax.alt_prune(cand, mask, alt_lb[dst], prune_bound)
        cand = torch.where(mask, cand, INF)
        n_pruned = count(pruned)
    best_l = relax.segment_partial_min(cand, dst, view.n)
    win_l = relax.winner_partial(cand, mask, src, dst, best_l, view.n)
    best, winner = _merge_partials(best_l, win_l, view.group)
    new_dist, new_parent, improved = relax.apply_updates(
        dist, parent, best, winner, gate=dist > lb)
    # pull scans (requester unsettled, weight short enough), requests and
    # requests cut by ALT
    counts = _sum(torch.stack([count((dv > lb) & (w < ub - st)),
                               count(mask), n_pruned]), view.group)
    metrics = metrics._replace(
        n_pull_trav=metrics.n_pull_trav + counts[0],
        n_extended=metrics.n_extended + count(improved & (view.deg > 1)),
        n_relax=metrics.n_relax + counts[1],
        n_updates=metrics.n_updates + count(improved),
        n_pruned=metrics.n_pruned + counts[2],
        n_rounds=metrics.n_rounds + 1)      # the pull phase is a round/sync
    return new_dist, new_parent, metrics


def _rank_view(sg: ShardedGraph, blocked, group, dev):
    """This rank's :class:`_ShardView` and, on ``blocked``, its
    :class:`_DeviceSlabs`, on ``dev`` (``deg`` gathered once)."""
    rank = tdist.get_rank(group)
    block = sg.deg.shape[1]
    t = lambda a, dtype=None: torch.from_numpy(
        np.ascontiguousarray(a)).to(dev, dtype)
    deg_l = t(sg.deg[rank])
    deg = torch.empty(block * sg.deg.shape[0], dtype=torch.int32, device=dev)
    tdist.all_gather_into_tensor(deg, deg_l, group=group)
    view = _ShardView(src=t(sg.src[rank], torch.int64),
                      dst=t(sg.dst[rank], torch.int64), w=t(sg.w[rank]),
                      deg=deg, rtow=t(sg.rtow),
                      n_edges2=torch.tensor(sg.n_edges2, dtype=torch.int32,
                                            device=dev),
                      group=group)
    slabs = None
    if blocked is not None:
        arrays, meta = blocked
        slabs = _DeviceSlabs(
            src=t(arrays.src[rank]), dst=t(arrays.dst[rank]),
            w=t(arrays.w[rank]), tile_first=t(arrays.tile_first[rank]),
            index=TileIndex(t(arrays.vt_ptr[rank]), t(arrays.vt_tile[rank]),
                            t(arrays.forced[rank])),
            base=rank * block, block=block, tile_e=meta.tile_e,
            dense_grid_tiles=meta.dense_grid_tiles)
    return view, slabs


def _run_v1(sg: ShardedGraph, blocked, source: int, group, dev,
            max_iters: int, alpha: float, beta: float, goal: str,
            goal_param: torch.Tensor, alt: Optional[relax.AltData],
            buf=None):
    view, slabs = _rank_view(sg, blocked, group, dev)
    c = single._consts(view.deg, alpha, beta)
    s = single._initial_state(view.n, source, dev)
    ac = None if alt is None else _make_alt_ctx(alt, source, goal_param,
                                                view.n)
    # every value a record reads is replicated (the state, the summed
    # counters), so the ring is the same on every rank
    return single._solve_loop(
        view, s, c, lambda s: _v1_relax_round(view, slabs, s, ac),
        lambda s: single._transition(
            view, s, c, min_pending=_v1_min_pending,
            pull_phase=_v1_pull_phase, goal=goal, goal_param=goal_param,
            alt_lb=None if ac is None else ac.lb,
            bound_of=None if ac is None else ac.bound),
        max_iters, buf)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _device_for(device) -> torch.device:
    """``device``, or the card of this process (``cuda:<local rank>``)."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        return resolve_device(None)          # raises: no card
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None \
        else tdist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def sssp_distributed(sg: ShardedGraph, source, group=None, *, version="v2",
                     max_iters=1_000_000, fused_rounds=0,
                     alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA, capacity=None,
                     goal="tree", goal_param=None, backend="segment_min",
                     blocked=None, block_v=None, tile_e=None,
                     policy="static", config=None, landmarks=None,
                     trace=False, trace_capacity=256, device=None):
    """Sharded SSSP from ``source`` over the ranks of ``group`` (default:
    the world group, which must be initialised).

    Every rank calls it with the same :class:`ShardedGraph` (one shard per
    rank) and the same arguments.  ``device`` defaults to this process's
    card (``cuda:<local rank>``); ``device="cpu"`` runs on the CPU.  The
    group's backend must match: NCCL for CUDA, gloo for the CPU.
    ``backend`` is ``"segment_min"`` or ``"blocked"``; with ``"blocked"``
    pass a prebuilt :func:`shard_blocked` layout as ``blocked=``, or
    ``block_v``/``tile_e`` for a one-off build.

    ``goal``/``goal_param`` select an early-exit query
    (:data:`~repro_torch.core.sssp.GOALS`: ``p2p`` with its target,
    ``bounded`` with its bound, ``knear`` with its k) that stops as the
    single-device one does.  ``landmarks`` (a
    :class:`~repro_torch.core.landmarks.LandmarkSet` or a raw
    :class:`~repro_torch.core.relax.AltData`) prunes a p2p query exactly
    with ALT and is ignored by the other goals.

    ``trace=True`` records one record per loop iteration in a ring of
    ``trace_capacity`` (:mod:`repro_torch.obs.trace`), replicated on
    every rank, and returns it as a fourth output.

    Only ``version="v1"`` is ported; the reference's default ``"v2"``
    stays the default and raises, as do ``fused_rounds``/``capacity``
    (v2/v3 knobs), the adaptive ``policy`` and ``config``.  Returns
    ``(dist, parent, metrics)`` over the padded vertex range ``[0,
    P*B)``, replicated on every rank, as device tensors.
    """
    if version in ("v2", "v3") or fused_rounds or capacity is not None:
        raise _later("version")
    if version != "v1":
        raise ValueError(f"unknown distributed version {version!r}")
    asked = {"policy": policy != "static", "config": config is not None}
    for name, on in asked.items():
        if on:
            raise _later(name)
    gp = goal_param_array(goal, goal_param)
    _check_goal_bounds(goal, gp, sg.n_true)
    alt = getattr(landmarks, "alt_data", landmarks) \
        if goal == "p2p" and landmarks is not None else None
    if alt is not None and alt.D.shape[1] != sg.n_true:
        raise ValueError(f"landmark distances span {alt.D.shape[1]} "
                         f"vertices, the graph {sg.n_true}")
    dev = _check_group(sg, group, device, "sssp_distributed")
    if not 0 <= int(source) < sg.n_true:
        raise ValueError(f"source {source} out of range for n={sg.n_true}")
    layout = _resolve_blocked(sg, backend, blocked, dev, block_v, tile_e)
    if alt is not None:
        alt = relax.AltData(*(t.to(dev) for t in alt))
    buf = trace_init(trace_capacity, dev) if trace else None
    with profiling.annotate("repro:sssp_dist_dispatch:v1"):
        out = _run_v1(sg, layout, int(source), group, dev, int(max_iters),
                      float(alpha), float(beta), goal, gp.to(dev), alt, buf)
    return out if buf is None else (*out, buf)


def _check_group(sg: ShardedGraph, group, device, what: str):
    """The solve's device, once the group is initialised, its backend
    matches the device (NCCL for CUDA, gloo for the CPU) and its size
    the shard count."""
    if not tdist.is_initialized():
        raise RuntimeError(f"{what} needs a process group: call "
                           "torch.distributed.init_process_group first")
    dev = _device_for(device)
    want = "nccl" if dev.type == "cuda" else "gloo"
    have = tdist.get_backend(group)
    if have != want:
        raise ValueError(f"the group's backend is {have!r}; a solve on "
                         f"{dev.type} needs {want!r}")
    n_shards = int(sg.src.shape[0])
    world = tdist.get_world_size(group)
    if world != n_shards:
        raise ValueError(f"graph has {n_shards} shards, the group "
                         f"{world} ranks")
    return dev


def sssp_distributed_batch(*args, **kwargs):
    """Batched sharded solves: not ported yet."""
    raise _later("batch")


def repair_distributed(sg: ShardedGraph, dist, parent, frontier, group=None,
                       *, version="v2", max_iters: int = 1_000_000,
                       capacity: int = 0, backend="segment_min",
                       blocked=None, block_v=None, tile_e=None,
                       device=None):
    """Incremental repair of a sharded SSSP state after an edge delta.

    ``dist``/``parent``/``frontier`` are the invalidated tentative state
    over the true (or padded) vertex range, as
    :func:`repro_torch.delta.repair_state` makes it from an
    :class:`~repro_torch.delta.AppliedDelta`; ``sg`` is the patched
    :class:`ShardedGraph` (:func:`repro_torch.delta.patch_sharded`).
    Every rank calls it with the same arguments, as
    :func:`sssp_distributed`.  The v1 loop relaxes full-window rounds
    (``lb = 0``, ``ub = +inf``, no step transitions): each rank's
    partials over its slab (``segment_min``, or with ``backend=
    "blocked"`` one ``edge_relax_partials`` call over its
    :func:`shard_blocked` slabs, from ``blocked=`` or built here from
    ``sg``), one ``all_reduce(MIN)`` of packed keys and one
    ``all_reduce(SUM)`` of counters a round, and the replicated commit;
    the loop goes on while the round improved a vertex, a flag every
    rank reads from the replicated state.  The result is bitwise the
    single-device repair's (:func:`repro_torch.delta.repair`).

    Returns ``(dist, parent, metrics)`` over the padded ``n_pad`` range
    (slice ``[:n]`` for the true vertices), replicated; the metrics
    count only the repair's own work.  ``version`` ``"v2"``/``"v3"``
    (the reference's default) raise ``NotImplementedError``, as
    ``capacity`` (v3's) does.
    """
    if version in ("v2", "v3") or capacity:
        raise _later("repair")
    if version != "v1":
        raise ValueError(f"unknown version {version!r}; expected v1/v2/v3")
    dev = _check_group(sg, group, device, "repair_distributed")
    layout = _resolve_blocked(sg, backend, blocked, dev, block_v, tile_e)
    view, slabs = _rank_view(sg, layout, group, dev)
    n_pad = view.n

    def padded(x, dtype, value):
        x = torch.as_tensor(x).to(dev, dtype)
        return torch.cat([x, torch.full((n_pad - x.shape[0],), value,
                                        dtype=dtype, device=dev)])
    dist = padded(dist, torch.float32, INF)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    s = SsspState(dist=dist, parent=padded(parent, torch.int32, -1),
                  frontier=padded(frontier, torch.bool, False), lb=zero,
                  ub=torch.full((), INF, device=dev), st=zero,
                  done=torch.zeros((), dtype=torch.bool, device=dev),
                  metrics=single._zero_metrics(dev))
    with profiling.annotate("repro:repair_dist_dispatch:v1"):
        # the state is replicated, so every rank reads the same flag
        go, syncs = bool(s.frontier.any()), 1
        for _ in range(max_iters):
            if not go:
                break
            s = _v1_relax_round(view, slabs, s)
            go, syncs = bool(s.frontier.any()), syncs + 1
    metrics = s.metrics._replace(n_host_syncs=torch.full(
        (), float(syncs), dtype=torch.float32, device=dev))
    return s.dist, s.parent, metrics
