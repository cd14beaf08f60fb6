"""Plain PyTorch versions of the edge_relax kernels and their prepass.

``edge_relax_ref`` is the one-round kernel's contract written with
``scatter_reduce``; ``schedule_tiles`` is the reference's
frontier-compaction prepass, and the oracle of ``frontier_schedule``, the
CUDA kernels' frontier-driven prepass written plainly;
``edge_relax_fused_ref`` is the multi-round fused kernel's contract and
``edge_relax_fused_steps`` the CUDA fused kernel's steps written plainly
(frontier list, index schedule, touched list, commit over it; tests
only);
``edge_relax_partials_ref`` is the one-round round with its counters,
which both one-round kernels (``edge_relax`` on a device's slabs,
``edge_relax_partials`` on a shard's) compute, and
``edge_relax_batch_ref`` the same round over several slots' states
(``edge_relax``'s batched entry).  Every kernel takes the
ALT cut as an option.  The wrappers in :mod:`.ops` run them for
CPU tensors, the tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.  All
work on any device.
"""
from __future__ import annotations

import torch

INT_MAX = 2 ** 31 - 1
# the packed (value bits, source id) key of no candidate: (+inf, INT_MAX)
EMPTY_KEY = (0x7F800000 << 32) | INT_MAX

# counter slots of the fused kernel's int32[8] result
FUSED_COUNTERS = ("n_trav", "n_relax", "n_updates", "n_extended",
                  "n_rounds", "n_tiles", "n_exec", "n_pruned")
# counter slots of the partials kernel's int32[4] result
PARTIAL_COUNTERS = ("n_trav", "n_relax", "n_tiles", "n_pruned")


def schedule_tiles(frontier_block, src_local, w, tile_first, tile_e: int):
    """Frontier-compaction prepass: compact the active tiles to the front.

    A tile is *active* when any of its edges has a frontier source and a
    finite weight (padding slots carry ``w=+inf``), or when it is the
    forced first tile of a bucket (``tile_first``).  Returns ``(sched,
    sched_n)``: the active tiles in layout order, then the last active
    tile repeated; ``sched_n`` (0-d int32) is the number of active tiles.
    """
    nt = tile_first.shape[0]
    touched = (frontier_block[src_local.long()] > 0) & torch.isfinite(w)
    active = touched.reshape(nt, tile_e).any(dim=1) | tile_first
    pos = torch.cumsum(active.to(torch.int32), 0).to(torch.int32) - 1
    sched_n = pos[-1] + 1
    idx = torch.arange(nt, dtype=torch.int32, device=w.device)
    slot = torch.where(active, pos, nt).long()
    sched = torch.zeros(nt + 1, dtype=torch.int32, device=w.device)
    sched = sched.scatter(0, slot, idx)[:nt]       # slot nt is dropped
    last = sched.index_select(0, torch.clamp(sched_n - 1, min=0).long()
                              .reshape(1))
    sched = torch.where(idx < sched_n, sched, last)
    return sched, sched_n


def frontier_schedule(paths, index, n_tiles: int):
    """The CUDA kernels' prepass, plainly: the tiles listed in ``index``
    (a :class:`~repro_torch.core.graph.TileIndex`) for every source with
    ``paths`` set, and the forced tiles, each once.  Returns ``(tiles,
    n)``: the scheduled tiles ascending (the kernel appends them in no
    fixed order) and their count (0-d int32), which must be exactly
    ``schedule_tiles``' active set and count."""
    vt_ptr, vt_tile, forced = index
    span = (vt_ptr[1:] - vt_ptr[:-1]).long()
    entry_live = torch.repeat_interleave(paths.bool(), span)
    flags = torch.zeros(n_tiles, dtype=torch.bool, device=paths.device)
    flags[vt_tile[:entry_live.shape[0]][entry_live].long()] = True
    flags[forced.long()] = True
    tiles = torch.nonzero(flags).reshape(-1).to(torch.int32)
    return tiles, torch.tensor(tiles.shape[0], dtype=torch.int32,
                               device=paths.device)


def edge_relax_ref(dist_block, frontier_block, src_local, dst_local, w,
                   lb, ub, alt_lb=None, prune_bound=None, *, n_out: int):
    """Returns ``(vals, winners)``: per destination over ``n_out``, the
    minimum in-window candidate ``dist[src] + w`` of a frontier source,
    and the smallest source id achieving it (``(inf, INT_MAX)`` where no
    candidate exists).  Source ids index ``dist_block``: block-local for
    one slab, global for a concatenated slab set.  With ``alt_lb`` (f32
    ``[n_out]``) and ``prune_bound`` (0-d f32), the ALT cut: a candidate
    enters only if ``cand + alt_lb[dst] <= prune_bound``."""
    src = src_local.long()
    dst = dst_local.long()
    cand = dist_block[src] + w
    ok = (frontier_block[src] > 0) & (cand >= lb) & (cand < ub)
    if alt_lb is not None:
        ok = ok & (cand + alt_lb[dst] <= prune_bound)
    cand = torch.where(ok, cand, torch.inf)
    best = torch.full((n_out,), torch.inf, dtype=torch.float32,
                      device=w.device).scatter_reduce_(0, dst, cand, "amin")
    win = torch.where(ok & (cand <= best[dst]), src_local.to(torch.int32),
                      INT_MAX)
    winner = torch.full((n_out,), INT_MAX, dtype=torch.int32,
                        device=w.device).scatter_reduce_(0, dst, win, "amin")
    return best, winner


def _count(mask):
    return mask.sum().to(torch.int32)


def _slab_counters(pa_src, w, dst, p_src, ok, tile_first, tile_e: int,
                   fail=None):
    """The fused kernels' traversal counters, computed slab-wide (exact:
    tiles outside the compacted schedule contribute zero to each).
    Returns ``(n_trav, n_relax, n_tiles, n_pruned)``: the in-window edges
    ``ok``, those not back along the source's parent edge and not cut by
    the ALT test ``fail`` (None: no ALT), the active tiles, and the
    parent-excluded edges that ``fail`` cut, so that ``n_relax`` without
    ALT is ``n_relax + n_pruned`` with it."""
    nt = w.shape[0] // tile_e
    touched = pa_src & torch.isfinite(w)
    active = touched.reshape(nt, tile_e).any(dim=1) | tile_first
    kept = ok & (dst != p_src)
    pruned = torch.zeros_like(kept) if fail is None else kept & fail
    return (_count(ok), _count(kept & ~pruned), _count(active),
            _count(pruned))


def edge_relax_fused_ref(dist, parent, frontier, deg, src, dst, w,
                         tile_first, lb, ub, alt_lb=None, prune_ub=None,
                         prune_infl=None, prune_tgt=None, *, tile_e: int,
                         fused_rounds: int):
    """Up to ``fused_rounds`` windowed relaxation rounds (one while
    ``lb <= 0``), stopping after the first round that improves nothing.

    ``dist`` f32, ``parent`` i32, ``frontier`` bool and ``deg`` i32 span
    the padded vertex range ``[0, n_out)``; ``src``/``dst``/``w`` are the
    whole concatenated slab with global ids, ``tile_first`` bool its
    forced tiles; ``lb``/``ub`` 0-d f32.  Each round leaf-prunes the
    frontier, relaxes every in-window candidate (min value, then min
    source id), commits the improvements, which become the next
    frontier, and adds to the int32 ``FUSED_COUNTERS``.  With ``alt_lb``
    (f32 ``[n_out]``), ``prune_ub``/``prune_infl`` (0-d f32) and
    ``prune_tgt`` (0-d i32), each round first computes the prune bound
    ``min(prune_ub, dist[prune_tgt] * prune_infl)`` from the current dist
    and drops the candidates with ``cand + alt_lb[dst]`` above it,
    counting the parent-excluded ones in ``n_pruned``.  Returns ``(dist,
    parent, frontier, counts)`` after the last executed round.
    """
    src_l = src.long()
    max_r = 1 if bool(lb <= 0.0) else fused_rounds
    cnt = torch.zeros(8, dtype=torch.int32, device=dist.device)
    zero = torch.zeros((), dtype=torch.int32, device=dist.device)
    for _ in range(max_r):
        paths = frontier & ((dist <= 0.0) | (deg > 1))
        pa_src = paths[src_l]
        cand = dist[src_l] + w
        ok = pa_src & (cand >= lb) & (cand < ub)
        bound = fail = None
        if alt_lb is not None:
            bound = torch.minimum(prune_ub, dist.index_select(
                0, prune_tgt.reshape(1).long()).reshape(()) * prune_infl)
            fail = cand + alt_lb[dst.long()] > bound
        best, winner = edge_relax_ref(dist, paths, src, dst, w, lb, ub,
                                      alt_lb, bound, n_out=dist.shape[0])
        trav, rlx, n_tiles, prn = _slab_counters(
            pa_src, w, dst, parent[src_l], ok, tile_first, tile_e, fail)
        improved = best < dist
        cnt = cnt + torch.stack([
            trav, rlx, _count(improved), _count(improved & (deg > 1)),
            frontier.any().to(torch.int32), n_tiles, zero + 1, prn])
        dist = torch.where(improved, best, dist)
        parent = torch.where(improved, winner, parent)
        frontier = improved
        if not bool(improved.any()):
            break
    return dist, parent, frontier, cnt


def edge_relax_fused_steps(dist, parent, frontier, deg, src, dst, w,
                           tile_first, lb, ub, alt_lb=None, prune_ub=None,
                           prune_infl=None, prune_tgt=None, *, tile_e: int,
                           fused_rounds: int, index):
    """The CUDA fused kernel's steps, plainly (tests only): the same
    function as :func:`edge_relax_fused_ref`, computed as
    ``csrc/edge_relax_fused.cu`` computes it.

    One pass lists the frontier.  Each round then schedules the forced
    tiles and, for each path source of the list, the tiles of its
    ``index`` entry that are not forced (each once); relaxes the
    scheduled tiles' slots into packed (value bits, source id) keys; lists
    the touched destinations (those whose key left ``EMPTY_KEY``); and
    commits over that list only, whose improved vertices are the next
    round's frontier list.  Returns ``(dist, parent, frontier,
    counts)``."""
    vt_ptr, vt_tile, forced = (a.long() for a in index)
    dev = dist.device
    n_out = dist.shape[0]
    max_r = 1 if bool(lb <= 0.0) else fused_rounds
    dist, parent = dist.clone(), parent.clone()
    front_list = torch.nonzero(frontier).reshape(-1)
    cnt = torch.zeros(8, dtype=torch.int32, device=dev)
    steps = torch.arange(tile_e, device=dev)
    for r in range(max_r):
        fl = front_list
        live = fl[(dist[fl] <= 0.0) | (deg[fl] > 1)]
        mark = torch.zeros(n_out, dtype=torch.bool, device=dev)
        mark[live] = True
        span = vt_ptr[live + 1] - vt_ptr[live]
        at = torch.repeat_interleave(vt_ptr[live], span) + (
            torch.arange(int(span.sum()), device=dev)
            - torch.repeat_interleave(torch.cumsum(span, 0) - span, span))
        tiles = torch.unique(vt_tile[at])
        tiles = tiles[~tile_first[tiles]]
        sched = torch.cat([forced, tiles])
        slots = (sched[:, None] * tile_e + steps[None, :]).reshape(-1)
        s = src[slots].long()
        d = dst[slots].long()
        c = dist[s] + w[slots]
        ok = mark[s] & (c >= lb) & (c < ub)
        notpar = d != parent[s].long()
        fail = torch.zeros_like(ok)
        if alt_lb is not None:
            bound = torch.minimum(prune_ub, dist[prune_tgt.long()]
                                  * prune_infl)
            fail = ok & ~(c + alt_lb[d] <= bound)
        kept = ok & ~fail
        keys = torch.full((n_out,), EMPTY_KEY, dtype=torch.int64,
                          device=dev)
        keys.scatter_reduce_(0, d[kept], (c[kept].view(torch.int32).long()
                                          << 32) | s[kept], "amin")
        touched = torch.unique(d[kept])      # the keys that left EMPTY_KEY
        key = keys[touched]
        val = (key >> 32).to(torch.int32).view(torch.float32)
        imp = val < dist[touched]
        improved = touched[imp]
        dist[improved] = val[imp]
        parent[improved] = (key[imp] & 0xFFFFFFFF).to(torch.int32)
        cnt += torch.stack([
            _count(ok), _count(kept & notpar), _count(imp),
            _count(deg[improved] > 1),
            torch.tensor(int(fl.numel() > 0), dtype=torch.int32, device=dev),
            torch.tensor(sched.numel(), dtype=torch.int32, device=dev),
            cnt.new_ones(()), _count(fail & notpar)])
        front_list = improved
        if improved.numel() == 0:
            break
    front = torch.zeros(n_out, dtype=torch.bool, device=dev)
    front[front_list] = True
    return dist, parent, front, cnt


def edge_relax_partials_ref(dist_src, paths_src, parent_src, src, dst, w,
                            tile_first, lb, ub, alt_lb=None,
                            prune_bound=None, *, tile_e: int, n_out: int):
    """One round over all of a shard's slabs against its local source
    range (or over a device's slabs against the whole range: the plain
    version of both one-round kernels).

    ``dist_src`` f32, ``paths_src`` bool and ``parent_src`` i32 span the
    shard's source range, which ``src`` (the slabs concatenated, slab
    offsets already added) indexes; ``dst`` holds global ids below
    ``n_out``.  Returns ``(val, win, counts)``: per destination the
    minimum in-window candidate of a path source and the smallest
    shard-local source id achieving it (``(inf, INT_MAX)`` where none),
    and the int32 ``PARTIAL_COUNTERS``: in-window slots, those not back
    along the source's parent edge and not pruned, the active tiles, and
    the pruned ones.  With ``alt_lb`` (f32 ``[n_out]``) and
    ``prune_bound`` (0-d f32), the ALT cut: a candidate with ``cand +
    alt_lb[dst] > prune_bound`` leaves the scatter-min whatever its
    parent, and ``n_pruned`` counts the cut ones not back along the
    parent edge, so that ``n_relax`` without the cut is ``n_relax +
    n_pruned`` with it; ``n_trav`` stays the in-window count.
    """
    src_l = src.long()
    pa_src = paths_src[src_l]
    cand = dist_src[src_l] + w
    ok = pa_src & (cand >= lb) & (cand < ub)
    fail = None
    if alt_lb is not None:
        fail = cand + alt_lb[dst.long()] > prune_bound
    val, win = edge_relax_ref(dist_src, paths_src, src, dst, w, lb, ub,
                              alt_lb, prune_bound, n_out=n_out)
    return val, win, torch.stack(_slab_counters(
        pa_src, w, dst, parent_src[src_l], ok, tile_first, tile_e, fail))


def edge_relax_batch_ref(dist, paths, parent, src, dst, w, tile_first, lb,
                         ub, alt_lb=None, prune_bound=None, *, tile_e: int,
                         n_out: int, active):
    """The one-round kernel over slots, plainly: for each slot in
    ``active`` the round of :func:`edge_relax_partials_ref` on its rows
    (``dist``, ``paths``, ``parent`` ``[S, n_src]``, ``lb``/``ub`` and
    ``prune_bound`` ``[S]``, ``alt_lb`` ``[S, n_out]``) over the shared
    slabs.  Returns ``(vals, wins, counts)`` of shapes ``[S, n_out]``,
    ``[S, n_out]`` and ``[S, 4]``; the rows of slots not in ``active``
    hold ``(inf, INT_MAX)`` and zero counters."""
    n_slots = dist.shape[0]
    vals = torch.full((n_slots, n_out), torch.inf, dtype=torch.float32,
                      device=dist.device)
    wins = torch.full((n_slots, n_out), INT_MAX, dtype=torch.int32,
                      device=dist.device)
    counts = torch.zeros(n_slots, 4, dtype=torch.int32, device=dist.device)
    for i in active.tolist():
        alt = () if alt_lb is None else (alt_lb[i], prune_bound[i])
        vals[i], wins[i], counts[i] = edge_relax_partials_ref(
            dist[i], paths[i], parent[i], src, dst, w, tile_first, lb[i],
            ub[i], *alt, tile_e=tile_e, n_out=n_out)
    return vals, wins, counts
