"""Sharded SSSP over ``torch.distributed``: the v1, v2 and v3 engines
(port of ``repro.core.distributed``).

Every rank calls the entry points with the same arguments (SPMD): rank
``q`` owns the vertex block ``[q*B, (q+1)*B)`` and the edges whose source
it owns, and each rank moves only its own shard to its device.  Every
loop decision is taken from values that are the same on every rank after
the collectives, so all ranks leave each loop together.

**v1, replicated dist / all-reduce-min** (the paper-faithful engine).
``dist``/``parent`` are replicated on every rank.  Each round every rank
relaxes its own edges into per-destination ``(min, winner)`` partials
over the whole padded vertex range, and one ``all_reduce(MIN)`` merges
them: the pair travels as one int64 key, ``bits(value) << 32 | global
winner``.  Candidates are non-negative or +inf, so the key orders by
value, then by id, which is the reference's two ``pmin``s (value, then
the winner among the ranks whose partial equals it) in one collective.
The counters are one ``all_reduce(SUM)``; ``deg`` is gathered once per
:class:`DeviceShard`.  The step transition is the single-device one (:mod:`.sssp`),
given the two places where v1 differs: the smallest pending candidate
is reduced across ranks, and the pull phase runs over the local slab (a
mirrored push; the graph stores both directions) with the same merge.

**v2, block-sharded dist / reduce-scatter-min.**  A rank holds
``dist``/``parent``/``frontier`` of its own block ``[B]`` only.  A round
relaxes the local slab into partials over the whole padded range, and
the exchange hands each rank the merged partials of its block: one
``reduce_scatter(MIN)`` of the same packed keys (the reference's
``all_to_all`` followed by ``combine_block_partials``, whose rule the
key order is).  The step transition works from local partials and
collectives: the smallest pending candidate (``MIN``), one ``SUM`` of
the degree and grid histograms and ``sumD`` partials from which every
rank computes the same ``gap`` and ``ST`` (the single-device formulas,
:func:`stepping.gap_from_stats` and
:func:`traversal.compute_st_from_stats`), the pull phase through the
exchange, the goal test (p2p: the target's owner tests it and a ``SUM``
spreads the answer; knear: a ``SUM`` of settled counts) and the first
step's tightening of ``ub`` (``MIN``).  A round's counters, its frontier
flag included, are one ``SUM``.  With ALT the target's owner reads
``dist[t]`` for the prune bound and a ``MIN`` sends it to every rank.

**v3, the compacted exchange.**  Each rank sends only the finite
candidates of each destination block, at most ``capacity`` of them
(default ``max(B // 16, 8)``), as ``(packed key, block-local index)``
pairs through one ``all_to_all``, and the receiver takes the smallest key
per vertex.  Once any rank's block holds more than ``capacity`` finite
candidates, every rank takes the dense exchange instead (a ``MAX`` of the
overflow flag).  Every finite candidate is sent and the padding is +inf,
so v3 gives exactly what v2 gives.  The flag decides the shape of the
collective, so v3 reads it on the host once per exchange (counted in
``n_host_syncs``); :data:`EXCHANGES` counts the exchanges by path.

``fused_rounds`` depends on the backend, as in the reference: on
``blocked`` it groups up to that many complete rounds, each with its
exchange, into one iteration (one round while ``lb <= 0``), bitwise the
unfused engine; the group makes no host read between its rounds (v2),
so rounds past the window's last improving round run on an empty
frontier, change nothing and are counted in the physical counters
only.  On ``segment_min`` it is the paper's bucket fusion: that many
local-only waves over the edges whose destination the rank owns before
each exchanged round, which relax more than the single-device engine
(bitwise the reference at the same number of ranks, not the
single-device solve).  v1 ignores ``fused_rounds``, as the reference
does.

Queries (``goal=``): ``p2p``, ``bounded`` and ``knear`` stop as the
single-device ones do.  A p2p query with ``landmarks`` prunes with ALT:
the per-vertex bound toward the target, padded with +inf to the padded
vertex range and replicated, and a prune bound ``min(seed, dist[t] *
infl)`` taken at the start of each round and each transition.  It cuts
the round's candidates (in the partials kernel on ``blocked``, with
:func:`relax.alt_prune` on ``segment_min``), the pending candidates of
the fast-forward, and the pull phase's requests, on ``lb[dst]``: in the
mirrored push the requester that receives the update is the destination.

Per-shard backends (``backend=``): ``segment_min`` relaxes the flat
local slab in plain torch; ``blocked`` relaxes the shard's
:class:`~repro_torch.core.graph.ShardSlice` slabs through one
``edge_relax_partials`` call per round (the CUDA kernel on the card, its
plain version on the CPU; with ALT, its ALT branch), on v1 over the
rank's slice of the replicated state, on v2/v3 over its local block.
Both give the same ``dist``/``parent`` and logical counters as the
single-device engine.

Options come as an :class:`~repro_torch.core.config.EngineConfig`
(``config=``, tier ``"sharded"``) or as the reference's loose keywords,
never both; the adaptive ``policy`` adapts the windows from the summed
counters on every rank alike.  :func:`sssp_distributed_batch` runs its
sources one after another, as the reference's ``lax.map`` does, so slots
do not multiply the per-rank state.  ``trace`` records one replicated
:mod:`~repro_torch.obs.trace` record per loop iteration (v2/v3 sum the
frontier census).  :func:`repair_distributed` re-relaxes a repaired state
after an edge delta (:mod:`repro_torch.delta`) with the version's round
and merge.  The results are gathered: every rank returns ``dist`` and
``parent`` over the padded range.

What a rank reads of the graph on its device is a :class:`DeviceShard`.
Each call copies the shard to the device once (a batch once for all its
sources); a caller that solves the same graph again builds one with
:func:`device_shard` and passes it as ``shard=``, as the sharded
``Solver`` and the registry's ``ShardedGraphEngine`` do.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from . import relax, stats, stepping, traversal
from . import sssp as single
from ..obs import profiling
from ..obs.trace import TraceBuf, trace_init
from .config import EngineConfig, as_resolved
from .graph import (HostGraph, TileIndex, degree_bucket, shard_block_v,
                    shard_geometry, slice_for_shard)
from .relax import INF, INT_MAX, count
from .sssp import (SsspMetrics, SsspState, _check_goal_bounds,
                   goal_param_array, resolve_device)

__all__ = ["ShardedGraph", "shard_graph", "BlockedShards",
           "BlockedShardMeta", "shard_blocked", "stack_tile_index",
           "DIST_BACKENDS", "EXCHANGES", "DeviceShard", "device_shard",
           "sssp_distributed", "sssp_distributed_batch",
           "repair_distributed"]

DIST_BACKENDS = ("segment_min", "blocked")


class _ExchangeCounts:
    """v2/v3 exchanges by path since the last :meth:`reset` (host-side,
    exact under threads): ``dense`` (the reduce-scatter, v2's and v3's
    fallback) and ``compact`` (v3's all-to-all of finite candidates)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.dense = 0
        self.compact = 0

    def add(self, path: str) -> None:
        with self._lock:
            setattr(self, path, getattr(self, path) + 1)

    def as_dict(self) -> dict:
        return {"dense": self.dense, "compact": self.compact}


EXCHANGES = _ExchangeCounts()


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
                     opts: dict, loose_opts: bool):
    """The (arrays, meta) pair the engine relaxes with, or ``None`` for
    ``segment_min``; ``opts`` are the layout geometry of a one-off build,
    ``loose_opts`` whether the caller passed them as keywords."""
    if _resolve_backend(backend) == "segment_min":
        if blocked is not None:
            raise ValueError("a blocked layout (blocked=) passed with "
                             "backend='segment_min'")
        return None
    if blocked is None:
        # a one-off build; callers that solve repeatedly build once
        return shard_blocked(sg, device=device, **opts)
    if loose_opts:
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


def _pack(val, win):
    """``bits(val) << 32 | win``: for values >= 0 or +inf and winners in
    ``[0, 2^31)`` the int64 order is the value's, then the winner's."""
    return (val.view(torch.int32).to(torch.int64) << 32) | win.to(torch.int64)


def _unpack(key):
    return ((key >> 32).to(torch.int32).view(torch.float32),
            (key & 0xFFFFFFFF).to(torch.int32))


# the packed key of an empty partial: +inf, no winner
_INF_KEY = (0x7F800000 << 32) | INT_MAX


# the newer names of reduce_scatter_tensor and all_gather_into_tensor
_reduce_scatter = getattr(tdist, "reduce_scatter_single", None) \
    or tdist.reduce_scatter_tensor
_all_gather = getattr(tdist, "all_gather_single", None) \
    or tdist.all_gather_into_tensor


def _merge_partials(val, win, group):
    """Merge per-rank ``(min, winner)`` partials in one
    ``all_reduce(MIN)`` of packed keys: the minimum value, and the
    smallest winner among the ranks that reach it."""
    key = _pack(val, win)
    tdist.all_reduce(key, op=tdist.ReduceOp.MIN, group=group)
    return _unpack(key)


def _sum(counts, group):
    tdist.all_reduce(counts, op=tdist.ReduceOp.SUM, group=group)
    return counts


def _all_min(x, group):
    """The minimum of the 0-d ``x`` over the ranks (a new 0-d tensor)."""
    x = x.reshape(1).clone()
    tdist.all_reduce(x, op=tdist.ReduceOp.MIN, group=group)
    return x.reshape(())


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


def _to_device(dev):
    return lambda a, dtype=None: torch.from_numpy(
        np.ascontiguousarray(a)).to(dev, dtype)


def _device_slabs(blocked, rank: int, block: int, dev) -> _DeviceSlabs:
    """Shard ``rank``'s blocked slabs of the stacked layout, on ``dev``."""
    arrays, meta = blocked
    t = _to_device(dev)
    return _DeviceSlabs(
        src=t(arrays.src[rank]), dst=t(arrays.dst[rank]),
        w=t(arrays.w[rank]), tile_first=t(arrays.tile_first[rank]),
        index=TileIndex(t(arrays.vt_ptr[rank]), t(arrays.vt_tile[rank]),
                        t(arrays.forced[rank])),
        base=rank * block, block=block, tile_e=meta.tile_e,
        dense_grid_tiles=meta.dense_grid_tiles)


def _run_v1(shard: "DeviceShard", slabs: Optional[_DeviceSlabs],
            source: int, max_iters: int, alpha: float, beta: float,
            goal: str, goal_param: torch.Tensor,
            alt: Optional[relax.AltData], policy: str = "static", buf=None):
    view, dev = shard.replicated(), shard.dev
    c = single._consts(view.deg, alpha, beta)
    s = single._initial_state(view.n, source, dev)
    ac = None if alt is None else _make_alt_ctx(alt, source, goal_param,
                                                view.n)
    # every value a record reads is replicated (the state, the summed
    # counters), so the ring is the same on every rank; so is the
    # adaptive policy's state, which the summed counters drive
    return single._solve_loop(
        view, s, c, lambda s: _v1_relax_round(view, slabs, s, ac),
        single._policy_transition(
            policy, c.params, dev,
            lambda s, **ps: single._transition(
                view, s, c, min_pending=_v1_min_pending,
                pull_phase=_v1_pull_phase, goal=goal,
                goal_param=goal_param,
                alt_lb=None if ac is None else ac.lb,
                bound_of=None if ac is None else ac.bound, **ps)),
        max_iters, buf)


# ---------------------------------------------------------------------------
# v2 / v3
# ---------------------------------------------------------------------------

class _LocalView(NamedTuple):
    """What the v2/v3 loop reads of the graph on one rank: the local edge
    slab (global and block-local source ids, int64 for indexing), the
    owner block's degrees, the collective group and the block geometry.
    No array here spans the whole graph."""
    src: torch.Tensor        # [E_max] int64 global source id
    src_l: torch.Tensor      # [E_max] int64 source id within the block
    dst: torch.Tensor        # [E_max] int64 global destination id
    w: torch.Tensor          # [E_max] float32
    deg: torch.Tensor        # [B] int32, the owner block's
    bucket: torch.Tensor     # [B] degree_bucket(deg)
    rtow: torch.Tensor
    n_edges2: torch.Tensor
    group: object
    rank: int
    world: int
    block: int

    @property
    def base(self) -> int:
        return self.rank * self.block

    @property
    def n_pad(self) -> int:
        return self.world * self.block


class DeviceShard:
    """This rank's shard of a :class:`ShardedGraph` on its device, with
    its slabs of a :func:`shard_blocked` layout when one is given: what a
    solve reads of the graph.  The entry points build one a call, so the
    shard crosses to the device once a call, not once a source; a caller
    that solves the same graph again builds it once with
    :func:`device_shard` and passes it as ``shard=`` (the sharded
    ``Solver`` and the registry's ``ShardedGraphEngine`` do).  Building
    it makes no collective, so one rank may build it alone; v1's
    replicated degrees are gathered by the first v1 solve on it, which
    every rank makes, and kept."""

    def __init__(self, sg: ShardedGraph, layout, group, dev):
        rank, world = tdist.get_rank(group), tdist.get_world_size(group)
        block = int(sg.deg.shape[1])
        t = _to_device(dev)
        src = t(sg.src[rank], torch.int64)
        deg = t(sg.deg[rank])
        self.sg, self.layout, self.group, self.dev = sg, layout, group, dev
        self.local = _LocalView(
            src=src, src_l=src - rank * block,
            dst=t(sg.dst[rank], torch.int64), w=t(sg.w[rank]), deg=deg,
            bucket=degree_bucket(deg), rtow=t(sg.rtow),
            n_edges2=torch.tensor(sg.n_edges2, dtype=torch.int32,
                                  device=dev),
            group=group, rank=rank, world=world, block=block)
        self.slabs = None if layout is None else _device_slabs(
            layout, rank, block, dev)
        self._replicated = None

    def replicated(self) -> _ShardView:
        """v1's view: the local slab and every rank's degrees (gathered
        on first use)."""
        if self._replicated is None:
            v = self.local
            deg = torch.empty(v.n_pad, dtype=torch.int32, device=self.dev)
            _all_gather(deg, v.deg, group=self.group)
            self._replicated = _ShardView(
                src=v.src, dst=v.dst, w=v.w, deg=deg, rtow=v.rtow,
                n_edges2=v.n_edges2, group=self.group)
        return self._replicated


def _default_capacity(block: int) -> int:
    """v3's candidates per destination block when the caller sets none."""
    return max(block // 16, 8)




def _exchange_dense(v: _LocalView, best_g, win_g):
    """The dense exchange: one ``reduce_scatter(MIN)`` of the packed
    partials over the padded range hands this rank the merged
    ``(min, winner)`` of its block."""
    out = torch.empty(v.block, dtype=torch.int64, device=best_g.device)
    _reduce_scatter(out, _pack(best_g, win_g), op=tdist.ReduceOp.MIN,
                    group=v.group)
    EXCHANGES.add("dense")
    return _unpack(out)


def _overflow(v: _LocalView, best_g, cap: int) -> bool:
    """Whether some rank holds more than ``cap`` finite candidates for
    one destination block: a ``MAX`` of the flag, read on the host."""
    n_finite = torch.isfinite(best_g.view(v.world, v.block)).sum(dim=1)
    flag = (n_finite > cap).any().to(torch.int32).reshape(1)
    tdist.all_reduce(flag, op=tdist.ReduceOp.MAX, group=v.group)
    return bool(flag)


def _exchange_compact(v: _LocalView, best_g, win_g, cap: int):
    """v3's exchange when no block overflows: each destination block's
    finite candidates, in block order and padded with +inf keys to
    ``cap``, go to the block's owner as (packed key, block-local index)
    pairs through one ``all_to_all``; the owner keeps the smallest key of
    each vertex.  Every finite candidate is sent, so the result is the
    dense exchange's wherever the minimum is finite (elsewhere it is
    +inf, which commits nothing).  The slots come from a running count
    of the finite entries, so no sort's tie order reaches a winner."""
    dev = best_g.device
    fin = torch.isfinite(best_g.view(v.world, v.block))
    # each finite candidate's slot in its row; the rest land in a spare
    # column that is cut off
    slot = torch.where(fin, torch.cumsum(fin, dim=1) - 1, cap)
    keys = torch.full((v.world, cap + 1), _INF_KEY, dtype=torch.int64,
                      device=dev)
    keys.scatter_(1, slot, _pack(best_g, win_g).view(v.world, v.block))
    idx = torch.zeros((v.world, cap + 1), dtype=torch.int64, device=dev)
    idx.scatter_(1, slot, torch.arange(v.block, device=dev)
                 .expand(v.world, v.block).contiguous())
    send = torch.stack([keys[:, :cap], idx[:, :cap]], dim=1).contiguous()
    recv = torch.empty_like(send)                       # [P, 2, cap]
    tdist.all_to_all_single(recv, send, group=v.group)
    out = torch.full((v.block,), _INF_KEY, dtype=torch.int64, device=dev)
    out.scatter_reduce_(0, recv[:, 1].reshape(-1), recv[:, 0].reshape(-1),
                        "amin")
    EXCHANGES.add("compact")
    return _unpack(out)


class _Exchange:
    """The version's exchange for one solve (v2: dense; v3: compact
    unless a block overflows ``capacity``), with the host reads it made."""

    def __init__(self, view: _LocalView, capacity: int):
        self.view, self.capacity, self.reads = view, capacity, 0

    def __call__(self, best_g, win_g):
        if self.capacity:
            self.reads += 1
            if not _overflow(self.view, best_g, self.capacity):
                return _exchange_compact(self.view, best_g, win_g,
                                         self.capacity)
        return _exchange_dense(self.view, best_g, win_g)


def _owner_at(v: _LocalView, x, i):
    """``x[i]`` on the rank that owns vertex ``i`` (0-d device tensor),
    and whether this rank is that owner."""
    own = torch.div(i, v.block, rounding_mode="floor") == v.rank
    return relax.at(x, torch.clamp(i - v.base, 0, v.block - 1)), own


def _alt_bound(v: _LocalView, dist, ac: _AltCtx):
    """The ALT prune bound at this ``dist``: the target's owner reads
    ``dist[t]`` and a ``MIN`` sends it to every rank."""
    d_t, own = _owner_at(v, dist, ac.tgt)
    d_t = _all_min(torch.where(own, d_t, INF), v.group)
    return torch.minimum(ac.seed, d_t * ac.infl)


def _v2_round(v: _LocalView, slabs: Optional[_DeviceSlabs], s: SsspState,
              ex: _Exchange, ac: Optional[_AltCtx] = None, trav0=None):
    """One synchronized round on the local block: the local slab's
    partials over the padded range, the exchange, the local commit and
    one ``SUM`` of the counters, the frontier flag among them.  Returns
    the state and the number of vertices the round improved (a 0-d
    tensor, the same on every rank).  ``trav0`` adds the bucket-fusion
    waves' local traversals to the round's sum."""
    dist, parent, frontier = s.dist, s.parent, s.frontier
    paths = relax.leaf_pruned(frontier, dist, v.deg)
    zero = torch.zeros((), dtype=torch.int32, device=dist.device)
    pb = None if ac is None else _alt_bound(v, dist, ac)
    if slabs is None:
        src_l = v.src_l
        cand, in_window, active = relax.edge_candidates(
            dist[src_l], paths[src_l], parent[src_l], v.dst, v.w, s.lb,
            s.ub)
        prn = zero
        if ac is not None:
            active, pruned = relax.alt_prune(cand, active, ac.lb[v.dst], pb)
            cand = torch.where(active, cand, INF)
            prn = count(pruned)
        best_g, win_g = relax.segment_min_with_winner(cand, active, v.src,
                                                      v.dst, v.n_pad)
        local = [count(in_window), count(active), zero, prn, zero]
        dense = 0
    else:
        best_g, win_g, n_tiles, trav, rlx, prn = \
            relax.blocked_shard_partials_fused(
                slabs.src, slabs.dst, slabs.w, slabs.tile_first, dist,
                paths, parent, slabs.base, s.lb, s.ub, tile_e=slabs.tile_e,
                n_out=v.n_pad, index=slabs.index,
                alt_lb=None if ac is None else ac.lb, prune_bound=pb)
        local = [trav, rlx, n_tiles, prn, zero + 1]
        dense = slabs.dense_grid_tiles
    if trav0 is not None:
        local[0] = local[0] + trav0
    best, winner = ex(best_g, win_g)
    new_dist, new_parent, improved = relax.apply_updates(dist, parent, best,
                                                         winner)
    # n_trav, n_relax, n_tiles, n_pruned, n_invocations, n_extended,
    # n_updates, ranks with a frontier
    c = _sum(torch.stack(local + [count(improved & (v.deg > 1)),
                                  count(improved),
                                  frontier.any().to(torch.int32)]), v.group)
    m = s.metrics
    metrics = m._replace(
        n_rounds=m.n_rounds + (c[7] > 0).to(torch.int32),
        n_extended=m.n_extended + c[5],
        n_trav=m.n_trav + c[0],
        n_relax=m.n_relax + c[1],
        n_updates=m.n_updates + c[6],
        n_pruned=m.n_pruned + c[3],
        n_tiles_scanned=m.n_tiles_scanned + c[2].to(torch.float32),
        n_tiles_dense=m.n_tiles_dense + float(dense),
        n_invocations=m.n_invocations + c[4].to(torch.float32))
    return s._replace(dist=new_dist, parent=new_parent, frontier=improved,
                      metrics=metrics), c[6]


def _fused_local(v: _LocalView, s: SsspState, waves: int, local_edge,
                 dst_local):
    """The paper's bucket fusion: ``waves`` local-only relaxations over
    the edges whose destination this rank owns, with no collective;
    cross-rank updates wait for the next exchange.  Unpruned (as in the
    reference).  Returns the state (frontier: every vertex a wave
    improved, with the incoming frontier) and the waves' local
    traversals."""
    dist, parent, front = s.dist, s.parent, s.frontier
    acc = front
    touched = torch.zeros((), dtype=torch.int32, device=dist.device)
    for _ in range(waves):
        paths = relax.leaf_pruned(front, dist, v.deg)
        cand, _, active = relax.edge_candidates(
            dist[v.src_l], local_edge & paths[v.src_l], parent[v.src_l],
            v.dst, v.w, s.lb, s.ub)
        best, winner = relax.segment_min_with_winner(cand, active, v.src,
                                                     dst_local, v.block)
        dist, parent, front = relax.apply_updates(dist, parent, best, winner)
        touched = touched + count(active)
        acc = acc | front
    return s._replace(dist=dist, parent=parent, frontier=acc), touched


def _v2_tighten(v: _LocalView, s: SsspState, high_d0) -> SsspState:
    """Algo 2 l.18-20 while ``lb <= 0``: ``ub`` down to the shortest
    known path to a vertex of degree >= highD(0), over every rank."""
    mask = (v.deg.to(torch.float32) >= high_d0) & (s.dist > 0)
    best = _all_min(torch.where(mask, s.dist, INF).min(), v.group)
    return s._replace(ub=torch.where(s.lb <= 0.0,
                                     torch.minimum(s.ub, best), s.ub))


def _v2_pull(v: _LocalView, dist, parent, st, lb, ub, metrics: SsspMetrics,
             ex: _Exchange, ac: Optional[_AltCtx] = None, bound=None):
    """Function 1's pull phase as a mirrored push from the settled band
    over the local slab, through the exchange; the unsettled gate applies
    on the owner side after it.  With ALT, requests with ``cand +
    lb[dst] > bound`` are cut (the requester is the destination)."""
    dv = dist[v.src_l]
    mask = (dv >= st) & (dv < lb) & (dv + v.w < ub)
    cand = torch.where(mask, dv + v.w, INF)
    prn = torch.zeros((), dtype=torch.int32, device=dist.device)
    if ac is not None:
        mask, pruned = relax.alt_prune(cand, mask, ac.lb[v.dst], bound)
        cand = torch.where(mask, cand, INF)
        prn = count(pruned)
    best_g, win_g = relax.segment_min_with_winner(cand, mask, v.src, v.dst,
                                                  v.n_pad)
    best, winner = ex(best_g, win_g)
    new_dist, new_parent, improved = relax.apply_updates(
        dist, parent, best, winner, gate=dist > lb)
    # pull scans, requests, requests cut by ALT, non-leaf updates, updates
    c = _sum(torch.stack([count((dv > lb) & (v.w < ub - st)), count(mask),
                          prn, count(improved & (v.deg > 1)),
                          count(improved)]), v.group)
    metrics = metrics._replace(
        n_pull_trav=metrics.n_pull_trav + c[0],
        n_extended=metrics.n_extended + c[3],
        n_relax=metrics.n_relax + c[1],
        n_updates=metrics.n_updates + c[4],
        n_pruned=metrics.n_pruned + c[2],
        n_rounds=metrics.n_rounds + 1)      # the pull phase is a round/sync
    return new_dist, new_parent, metrics


def _v2_goal_reached(v: _LocalView, goal: str, gp, dist, lb):
    """The goal test on the block-sharded ``dist``: the p2p target's
    owner tests it and a ``SUM`` spreads the answer; knear sums the
    settled counts; both decide as the single-device test does."""
    if goal == "tree":
        return torch.zeros((), dtype=torch.bool, device=dist.device)
    if goal == "bounded":
        return lb > gp
    if goal == "p2p":
        d_t, own = _owner_at(v, dist, gp)
        hit = (own & relax.settled_mask(d_t, lb)).to(torch.int32)
        return _sum(hit.reshape(1), v.group)[0] > 0
    if goal == "knear":
        n_settled = count(relax.settled_mask(dist, lb)).reshape(1)
        return _sum(n_settled, v.group)[0] >= gp + 1
    raise ValueError(f"unknown goal {goal!r}")


class _V2Consts(NamedTuple):
    params: stepping.SteppingParams
    unit_grid: torch.Tensor   # st_grid_points(1)
    high_d0: torch.Tensor     # highD(0), from the summed degree histogram


def _v2_consts(v: _LocalView, alpha: float, beta: float) -> _V2Consts:
    dev = v.deg.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    hist = _sum(stats.degree_hist(torch.zeros(v.block, dtype=torch.float32,
                                              device=dev), v.deg, zero,
                                  v.bucket), v.group)
    return _V2Consts(
        params=stepping.SteppingParams(alpha=alpha, beta=beta),
        unit_grid=traversal.st_grid_points(
            torch.ones((), dtype=torch.float32, device=dev)),
        high_d0=stats.high_d_from_hist(hist))


def _v2_transition(v: _LocalView, s: SsspState, c: _V2Consts,
                   ex: _Exchange, goal: str, gp,
                   ac: Optional[_AltCtx] = None,
                   ps: Optional[stepping.PolicyState] = None):
    """The step transition on the local block, with the single-device
    formulas fed by summed partials: the smallest pending candidate
    (``MIN``), one ``SUM`` of the degree histograms and ``sumD`` at
    ``lb``, at ``ub`` and at that candidate (the fast-forward's ``lb``)
    and of the grid histogram, then ``gap``/``ST`` as the single-device
    engine computes them, the pull phase (computed and selected, no host
    read), the goal test and the next window's frontier.  With ``ps``
    (adaptive) returns ``(state, ps)``."""
    dist, parent, lb, ub = s.dist, s.parent, s.lb, s.ub
    pend = dist[v.src_l] + v.w
    pend = torch.where(pend >= ub, pend, INF)
    bound = None
    if ac is not None:
        # a pending candidate the ALT bound would cut cannot improve the
        # target, so skipping it in fast-forward/termination is exact
        bound = _alt_bound(v, dist, ac)
        pend = torch.where(pend + ac.lb[v.dst] > bound, INF, pend)
    min_pending = _all_min(pend.min(), v.group)
    done = ~torch.isfinite(min_pending)
    params, mult = c.params, None
    if ps is not None:
        m = s.metrics
        ps = stepping.adaptive_update(ps, m.n_rounds, m.n_relax, m.n_updates)
        params, mult = stepping.effective_params(ps), ps.mult
    grid = c.unit_grid * ub

    def at(x):
        return [stats.degree_hist(dist, v.deg, x, v.bucket),
                stats.sum_d(dist, v.deg, x).reshape(1)]
    parts = at(lb) + at(ub) + [stats.grid_hist(dist, v.deg, grid)] \
        + at(min_pending)
    h_lb, sd_lb, h_ub, sd_ub, g_hist, h_mp, sd_mp = _sum(
        torch.cat(parts), v.group).split([p.shape[0] for p in parts])

    def gap(hist, sd):
        return stepping.gap_from_stats(sd.reshape(()),
                                       stats.high_d_from_hist(hist), v.rtow,
                                       v.n_edges2, params, mult)
    gap_ub = gap(h_ub, sd_ub)
    st_next = traversal.compute_st_from_stats(
        grid, stats.sum_d_grid_from_hist(g_hist), sd_ub.reshape(()),
        gap(h_lb, sd_lb), gap_ub, v.rtow, v.n_edges2, ub)
    lb2 = ub
    ub2 = lb2 + gap_ub
    # empty-window fast-forward (exact: no shortest path in the skip)
    ffwd = (min_pending >= ub2) & ~done
    lb2 = torch.where(ffwd, min_pending, lb2)
    ub2 = torch.where(ffwd, lb2 + gap(h_mp, sd_mp), ub2)
    st_next = torch.minimum(st_next, lb2)

    pull = st_next < lb2
    p_dist, p_parent, p_m = _v2_pull(v, dist, parent, st_next, lb2, ub2,
                                     s.metrics, ex, ac, bound)
    dist = torch.where(pull, p_dist, dist)
    parent = torch.where(pull, p_parent, parent)
    metrics = SsspMetrics(*[torch.where(pull, a, b)
                            for a, b in zip(p_m, s.metrics)])
    done = done | _v2_goal_reached(v, goal, gp, dist, lb2)
    frontier = relax.window_frontier(dist, st_next, lb2, ub2,
                                     v.rtow[-1]) & ~done
    metrics = metrics._replace(
        n_steps=metrics.n_steps + (~done).to(torch.int32))
    out = s._replace(dist=dist, parent=parent, frontier=frontier, lb=lb2,
                     ub=ub2, st=st_next, done=done, metrics=metrics)
    return out if ps is None else (out, ps)


def _v2_initial_state(v: _LocalView, source: int, dev) -> SsspState:
    """A fresh solve's state on the local block: the source set where
    this rank owns it; the window, flags and counters of
    :func:`single._initial_state`."""
    at_src = torch.arange(v.block, device=dev) + v.base == source
    s = single._initial_state(1, 0, dev)
    return s._replace(
        dist=torch.where(at_src, 0.0, INF).to(torch.float32),
        parent=torch.where(at_src, source, -1).to(torch.int32),
        frontier=at_src)


class _V2Steps:
    """The v2/v3 engine's hooks into :func:`single._solve_loop`.  The
    relaxation step keeps its round's summed improvement count, which is
    the frontier flag; the tightening of ``ub`` (a ``MIN``) runs only
    before the first transition, while ``lb <= 0`` holds (that transition
    moves ``lb`` to the tightened ``ub``, a positive dist or +inf, or past
    it); the trace's snapshot sums the frontier census."""

    def __init__(self, v: _LocalView, c: _V2Consts, round_step, transition):
        self.v, self.c = v, c
        self.round_step, self._transition = round_step, transition
        self.first, self.n_improved = True, None

    def relax(self, s: SsspState) -> SsspState:
        s, self.n_improved = self.round_step(s, self.first)
        return s

    def tighten(self, s: SsspState) -> SsspState:
        return _v2_tighten(self.v, s, self.c.high_d0) if self.first else s

    def any_front(self, s: SsspState):
        return self.n_improved > 0

    def transition(self, s: SsspState) -> SsspState:
        self.first = False
        return self._transition(s)

    def snap(self, s: SsspState):
        snap = single._trace_snap(s)
        return snap._replace(frontier=_sum(snap.frontier.reshape(1),
                                           self.v.group).reshape(()))


def _gather(x, v: _LocalView):
    """Every rank's block of ``x``, concatenated over the padded range."""
    out = torch.empty(v.n_pad, dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous(), group=v.group)
    return out


def _run_v2(shard: DeviceShard, slabs: Optional[_DeviceSlabs],
            source: int, max_iters: int, alpha: float, beta: float,
            fused_rounds: int, capacity: int, goal: str,
            goal_param: torch.Tensor, alt: Optional[relax.AltData],
            policy: str = "static", buf=None):
    """One v2 (``capacity`` 0) or v3 solve; returns ``(dist, parent,
    metrics)`` gathered over the padded range on every rank."""
    v, dev = shard.local, shard.dev
    ex = _Exchange(v, capacity)
    c = _v2_consts(v, alpha, beta)
    ac = None if alt is None else _make_alt_ctx(alt, source, goal_param,
                                                v.n_pad)
    if slabs is not None and fused_rounds > 0:
        def relax_step(s, first):
            # grouped complete rounds, one while lb <= 0; no host read
            # between them
            for _ in range(1 if first else fused_rounds):
                s, n_improved = _v2_round(v, slabs, s, ex, ac)
            return s, n_improved
    elif fused_rounds > 0:
        local_edge = torch.div(v.dst, v.block, rounding_mode="floor") \
            == v.rank
        dst_local = torch.clamp(v.dst - v.base, 0, v.block - 1)

        def relax_step(s, first):
            s, touched = _fused_local(v, s, fused_rounds, local_edge,
                                      dst_local)
            return _v2_round(v, slabs, s, ex, ac, touched)
    else:
        def relax_step(s, first):
            return _v2_round(v, slabs, s, ex, ac)
    steps = _V2Steps(v, c, relax_step, single._policy_transition(
        policy, c.params, dev,
        lambda s, **ps: _v2_transition(v, s, c, ex, goal, goal_param, ac,
                                       **ps)))
    dist, parent, metrics = single._solve_loop(
        v, _v2_initial_state(v, source, dev), c, steps.relax,
        steps.transition, max_iters, buf, tighten=steps.tighten,
        any_front=steps.any_front, snap=steps.snap)
    metrics = metrics._replace(n_host_syncs=metrics.n_host_syncs + ex.reads)
    return _gather(dist, v), _gather(parent, v), metrics


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


def _engine_args(sg: ShardedGraph, config, loose: dict):
    """The resolved engine of one call, from ``config`` or from the loose
    keywords, never both (:meth:`EngineConfig.from_loose`), on the
    sharded tier with one shard per rank (the reference's
    ``_dist_engine_args``)."""
    config = EngineConfig.from_loose(config, "engine",
                                     defaults={"tier": "sharded"}, **loose)
    return as_resolved(config, n=sg.n_true, m=sg.n_edges2,
                       n_devices=int(sg.src.shape[0])).require("sharded")


def device_shard(sg: ShardedGraph, blocked=None, group=None, *,
                 device=None) -> DeviceShard:
    """This rank's :class:`DeviceShard` of ``sg`` (and, with ``blocked``,
    of that :func:`shard_blocked` layout) on ``device`` (default: this
    process's card), for the entry points' ``shard=``.  A solve on
    ``blocked`` needs a shard built with its layout; a ``segment_min``
    solve reads the edge slab of either."""
    dev = _check_group(sg, group, device, "device_shard")
    if blocked is not None:
        blocked = _resolve_blocked(sg, "blocked", blocked, dev, {}, False)
    return DeviceShard(sg, blocked, group, dev)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _setup(sg: ShardedGraph, r, group, device, blocked, loose_layout: bool,
           goal: str, landmarks, what: str, shard: Optional[DeviceShard]):
    """``(device, shard, slabs, alt)`` of a call: the group checked, this
    rank's :class:`DeviceShard` (``shard``, checked against the call, or
    built here with the blocked layout resolved or built), the slabs the
    backend relaxes (None on ``segment_min``), the ALT data of a p2p
    query on the device."""
    alt = getattr(landmarks, "alt_data", landmarks) \
        if goal == "p2p" and landmarks is not None else None
    if alt is not None and alt.D.shape[1] != sg.n_true:
        raise ValueError(f"landmark distances span {alt.D.shape[1]} "
                         f"vertices, the graph {sg.n_true}")
    blocked_backend = _resolve_backend(r.shard_backend) == "blocked"
    if shard is None:
        dev = _check_group(sg, group, device, what)
        shard = DeviceShard(sg, _resolve_blocked(
            sg, r.shard_backend, blocked, dev, r.blocked_opts(),
            loose_layout), group, dev)
    else:
        if shard.sg is not sg or shard.group is not group:
            raise ValueError(f"{what}: the shard was built for another "
                             "graph or group")
        if blocked is not None or loose_layout:
            raise ValueError(f"{what}: the shard carries the layout; pass "
                             "blocked= to device_shard, not with shard=")
        if blocked_backend and shard.slabs is None:
            raise ValueError(f"{what}: backend 'blocked' needs a shard "
                             "built with a blocked layout")
        dev = _check_group(sg, group, shard.dev, what)
        if device is not None and not _same_device(resolve_device(device),
                                                   dev):
            raise ValueError(f"{what}: the shard is on {dev}, the call "
                             f"asks for {device}")
    if alt is not None:
        alt = relax.AltData(*(t.to(dev) for t in alt))
    return dev, shard, shard.slabs if blocked_backend else None, alt


def _check_sources(sources, n: int) -> None:
    bad = [s for s in sources if not 0 <= int(s) < n]
    if bad:
        raise ValueError(f"source(s) {bad} out of range for n={n}")


def _solve(shard: DeviceShard, slabs, source: int, r, goal: str,
           gp: torch.Tensor, alt, buf):
    """One solve of the resolved engine ``r``; ``(dist, parent,
    metrics)`` over the padded range."""
    args = (shard, slabs, source, r.max_iters, float(r.alpha),
            float(r.beta))
    if r.shard_version == "v1":
        return _run_v1(*args, goal, gp, alt, r.policy, buf)
    capacity = 0 if r.shard_version == "v2" else (
        r.compact_capacity or _default_capacity(shard.local.block))
    return _run_v2(*args, r.fused_rounds, capacity, goal, gp, alt, r.policy,
                   buf)


def _loose(version, max_iters, fused_rounds, alpha, beta, capacity, backend,
           block_v, tile_e, policy, trace, trace_capacity) -> dict:
    return dict(shard_version=version, max_iters=max_iters,
                fused_rounds=fused_rounds, alpha=alpha, beta=beta,
                compact_capacity=capacity, shard_backend=backend,
                block_v=block_v, tile_e=tile_e, policy=policy, trace=trace,
                trace_capacity=trace_capacity)


def sssp_distributed(sg: ShardedGraph, source, group=None, *, version=None,
                     max_iters=None, fused_rounds=None, alpha=None,
                     beta=None, capacity=None, goal="tree", goal_param=None,
                     backend=None, blocked=None, block_v=None, tile_e=None,
                     policy=None, config=None, landmarks=None, trace=None,
                     trace_capacity=None, device=None, shard=None):
    """Sharded SSSP from ``source`` over the ranks of ``group`` (default:
    the world group, which must be initialised).

    Every rank calls it with the same :class:`ShardedGraph` (one shard per
    rank) and the same arguments.  ``device`` defaults to this process's
    card (``cuda:<local rank>``); ``device="cpu"`` runs on the CPU.  The
    group's backend must match: NCCL for CUDA, gloo for the CPU.

    The engine options come as ``config`` (an
    :class:`~repro_torch.core.config.EngineConfig` or a resolved one, on
    the sharded tier) or as the reference's loose keywords, never both:
    ``version`` (``"v1"``, ``"v2"`` (default) or ``"v3"``),
    ``max_iters``, ``alpha``/``beta``, ``policy`` (``"static"`` or
    ``"adaptive"``), ``fused_rounds`` (see the module docstring),
    ``capacity`` (v3's per-block candidates; 0 is the default), ``backend``
    (``"segment_min"`` or ``"blocked"``), ``block_v``/``tile_e`` (a
    one-off blocked build; or pass a prebuilt :func:`shard_blocked` layout
    as ``blocked=``) and ``trace``/``trace_capacity``.  ``shard`` (a
    :func:`device_shard` of ``sg`` on this rank, built once by a caller
    that solves the graph again) replaces ``blocked``/``block_v``/
    ``tile_e`` and saves copying the shard to the device.

    ``goal``/``goal_param`` select an early-exit query
    (:data:`~repro_torch.core.sssp.GOALS`: ``p2p`` with its target,
    ``bounded`` with its bound, ``knear`` with its k) that stops as the
    single-device one does.  ``landmarks`` (a
    :class:`~repro_torch.core.landmarks.LandmarkSet` or a raw
    :class:`~repro_torch.core.relax.AltData`) prunes a p2p query exactly
    with ALT and is ignored by the other goals.  A traced config records
    one record per loop iteration, the same on every rank, and returns
    the ring as a fourth output.

    Returns ``(dist, parent, metrics)`` over the padded vertex range
    ``[0, P*B)`` on every rank, as device tensors.
    """
    r = _engine_args(sg, config, _loose(
        version, max_iters, fused_rounds, alpha, beta, capacity, backend,
        block_v, tile_e, policy, trace, trace_capacity))
    gp = goal_param_array(goal, goal_param)
    _check_goal_bounds(goal, gp, sg.n_true)
    dev, shard, slabs, alt = _setup(
        sg, r, group, device, blocked,
        block_v is not None or tile_e is not None, goal, landmarks,
        "sssp_distributed", shard)
    _check_sources([source], sg.n_true)
    buf = trace_init(r.trace_cap, dev) if r.trace_cap > 0 else None
    with profiling.annotate(f"repro:sssp_dist_dispatch:{r.shard_version}"):
        out = _solve(shard, slabs, int(source), r, goal, gp.to(dev), alt,
                     buf)
    return out if buf is None else (*out, buf)


def sssp_distributed_batch(sg: ShardedGraph, sources, group=None, *,
                           version=None, max_iters=None, fused_rounds=None,
                           alpha=None, beta=None, capacity=None,
                           goal="tree", goal_params=None, backend=None,
                           blocked=None, block_v=None, tile_e=None,
                           policy=None, config=None, landmarks=None,
                           trace=None, trace_capacity=None, device=None,
                           shard=None):
    """Batched sharded SSSP, the sharded serving tier's entry point.

    The sources run one after another, as the reference's ``lax.map``
    runs them: the sharded tier is for graphs whose per-rank state is the
    memory budget, so slots must not multiply it.  All slots share the
    ``goal`` kind, with one target / bound / k per source in
    ``goal_params``; every slot is bitwise its :func:`sssp_distributed`
    solve.  Options as in :func:`sssp_distributed`; the shard crosses to
    the device once for the batch (or never, with ``shard=``).  Returns ``(dist,
    parent, metrics)`` with a leading ``[S]`` axis (``[S, P*B]``), and a
    traced config's rings stacked ``[S, cap, cols]``.
    """
    r = _engine_args(sg, config, _loose(
        version, max_iters, fused_rounds, alpha, beta, capacity, backend,
        block_v, tile_e, policy, trace, trace_capacity))
    src = np.asarray(sources, np.int64)
    if src.ndim != 1 or src.size == 0:
        raise ValueError(f"sources must be a non-empty 1-D sequence, got "
                         f"shape {src.shape}")
    if goal == "tree" and goal_params is None:
        goal_params = [0] * src.shape[0]
    gp = goal_param_array(goal, goal_params)
    if tuple(gp.shape) != src.shape:
        raise ValueError(f"goal_params shape {tuple(gp.shape)} != sources "
                         f"shape {src.shape}")
    _check_goal_bounds(goal, gp, sg.n_true)
    dev, shard, slabs, alt = _setup(
        sg, r, group, device, blocked,
        block_v is not None or tile_e is not None, goal, landmarks,
        "sssp_distributed_batch", shard)
    _check_sources(src.tolist(), sg.n_true)
    outs, bufs = [], []
    with profiling.annotate(
            f"repro:sssp_dist_batch_dispatch:{r.shard_version}"):
        for i, s in enumerate(src.tolist()):
            buf = trace_init(r.trace_cap, dev) if r.trace_cap > 0 else None
            outs.append(_solve(shard, slabs, s, r, goal, gp[i].to(dev), alt,
                               buf))
            bufs.append(buf)
    stack = lambda xs: torch.stack(list(xs))
    out = (stack(o[0] for o in outs), stack(o[1] for o in outs),
           SsspMetrics(*map(stack, zip(*(o[2] for o in outs)))))
    if r.trace_cap <= 0:
        return out
    return (*out, TraceBuf(*map(stack, zip(*bufs))))


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
    :func:`sssp_distributed`.  The loop relaxes full-window rounds (``lb
    = 0``, ``ub = +inf``, no step transitions) with the version's round
    and merge: v1 over the replicated state (one ``all_reduce(MIN)`` of
    packed keys), v2/v3 over each rank's block through the exchange (v3's
    ``capacity`` defaults to ``max(B // 16, 8)``, as in the reference; v1
    and v2 ignore it).  Each rank's partials come from its slab
    (``segment_min``) or, with ``backend="blocked"``, from one
    ``edge_relax_partials`` call over its :func:`shard_blocked` slabs
    (``blocked=``, or built here from ``sg``).  The loop goes on while a
    round improved a vertex, a count every rank sums.  The result is
    bitwise a from-scratch solve's on the patched graph.

    Returns ``(dist, parent, metrics)`` over the padded ``n_pad`` range
    (slice ``[:n]`` for the true vertices) on every rank; the metrics
    count only the repair's own work.
    """
    if version not in ("v1", "v2", "v3"):
        raise ValueError(f"unknown version {version!r}; expected v1/v2/v3")
    dev = _check_group(sg, group, device, "repair_distributed")
    opts = {k: x for k, x in (("block_v", block_v), ("tile_e", tile_e))
            if x is not None}
    layout = _resolve_blocked(sg, backend, blocked, dev, opts, bool(opts))
    n_pad = sg.deg.size

    def padded(x, dtype, value):
        x = torch.as_tensor(x).to(dev, dtype)
        return torch.cat([x, torch.full((n_pad - x.shape[0],), value,
                                        dtype=dtype, device=dev)])
    dist = padded(dist, torch.float32, INF)
    parent = padded(parent, torch.int32, -1)
    frontier = padded(frontier, torch.bool, False)
    shard = DeviceShard(sg, layout, group, dev)
    with profiling.annotate(f"repro:repair_dist_dispatch:{version}"):
        if version == "v1":
            return _repair_v1(shard, dist, parent, frontier, max_iters)
        capacity = (capacity or _default_capacity(int(sg.deg.shape[1]))) \
            if version == "v3" else 0
        return _repair_v2(shard, dist, parent, frontier, max_iters,
                          capacity)


def _repair_state(dist, parent, frontier) -> SsspState:
    dev = dist.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return SsspState(dist=dist, parent=parent, frontier=frontier, lb=zero,
                     ub=torch.full((), INF, device=dev), st=zero,
                     done=torch.zeros((), dtype=torch.bool, device=dev),
                     metrics=single._zero_metrics(dev))


def _with_syncs(metrics: SsspMetrics, syncs: int, dev) -> SsspMetrics:
    return metrics._replace(n_host_syncs=torch.full(
        (), float(syncs), dtype=torch.float32, device=dev))


def _repair_v1(shard: DeviceShard, dist, parent, frontier,
               max_iters: int):
    view, slabs, dev = shard.replicated(), shard.slabs, shard.dev
    s = _repair_state(dist, parent, frontier)
    # the state is replicated, so every rank reads the same flag
    go, syncs = bool(s.frontier.any()), 1
    for _ in range(max_iters):
        if not go:
            break
        s = _v1_relax_round(view, slabs, s)
        go, syncs = bool(s.frontier.any()), syncs + 1
    return s.dist, s.parent, _with_syncs(s.metrics, syncs, dev)


def _repair_v2(shard: DeviceShard, dist, parent, frontier,
               max_iters: int, capacity: int):
    v, slabs, dev = shard.local, shard.slabs, shard.dev
    ex = _Exchange(v, capacity)
    lo, hi = v.base, v.base + v.block
    s = _repair_state(dist[lo:hi], parent[lo:hi], frontier[lo:hi])
    go = bool(_sum(count(s.frontier).reshape(1), v.group)[0] > 0)
    syncs = 1
    for _ in range(max_iters):
        if not go:
            break
        s, n_improved = _v2_round(v, slabs, s, ex)
        go, syncs = bool(n_improved > 0), syncs + 1
    return (_gather(s.dist, v), _gather(s.parent, v),
            _with_syncs(s.metrics, syncs + ex.reads, dev))
