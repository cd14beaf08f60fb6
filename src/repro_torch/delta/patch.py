"""In-place layout patching for edge deltas (port of ``repro.delta.patch``).

Three patchers, each equal to a from-scratch rebuild of the same
structure:

- :func:`patch_host` edits the CSR ``HostGraph`` (the ground truth every
  device layout derives from).  It reproduces ``build_csr``'s pipeline:
  a stable ``lexsort((w, src))`` over [kept edges in old CSR order, then
  adds] (sorting by weight only the rows an edit touched), degree/row_ptr
  recompute, and the RtoW quantile LUT over float64-promoted weights, so
  the patched host is bitwise the rebuild from the edited edge list.
  Its :class:`AppliedDelta` is the reference's, array for array.
- :func:`patch_blocked` patches the port's blocked layout (the slabs of
  all source blocks stored concatenated, with global source ids, and the
  vertex->tile index the kernels schedule from).  A directed edit lands
  in one (source block, destination block) bucket.  Where the touched
  slab's per-bucket tile counts are unchanged (tile padding absorbs the
  edit), only the touched buckets' slots are rewritten; otherwise the
  slab is re-bucketed, and if its tile count changed, the tiles of every
  later slab shift.  The touched blocks' part of the index is rebuilt
  (tile ids after a shifted slab move with it).
- :func:`patch_sharded` patches the sharded engines' per-shard edge
  slabs, rewriting only the shards that own an edited source vertex (the
  whole table is re-padded only when a shard outgrows ``e_max``).

The ``*_with`` variants take an already-patched host, so that one
:func:`patch_host` call serves every layout of a graph.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core import distributed, graph
from ..core.graph import BlockedGraph, HostGraph, TileIndex
from .edits import (AppliedDelta, EdgeDelta, KIND_ADD, KIND_DECREASE,
                    KIND_INCREASE, KIND_REMOVE, KIND_SAME)

__all__ = ["patch_host", "patch_blocked", "patch_blocked_with",
           "patch_sharded", "patch_sharded_with"]


def _find_slot(row_ptr: np.ndarray, dst: np.ndarray, u: int, v: int) -> int:
    lo, hi = int(row_ptr[u]), int(row_ptr[u + 1])
    rel = np.nonzero(dst[lo:hi] == v)[0]
    if rel.size == 0:
        raise ValueError(f"directed edge ({u}, {v}) not present in graph")
    return lo + int(rel[0])   # first match in CSR order: deterministic
    # with parallel edges — the lightest copy is the one edited


def patch_host(hg: HostGraph, delta: EdgeDelta
               ) -> Tuple[HostGraph, AppliedDelta]:
    """Apply ``delta`` to a host CSR; returns ``(new_host, applied)``.

    Bitwise ``build_csr`` over the edited edge list: weights are edited
    as float32 and promoted to float64 only for the quantile LUT, as the
    builder does (the promotion is monotone, so the stable sort's
    permutation is the same too).
    """
    n = hg.n
    s = np.asarray(hg.src, np.int64)
    d = np.asarray(hg.dst, np.int64)
    w = np.asarray(hg.w, np.float32).copy()
    row_ptr = np.asarray(hg.row_ptr, np.int64)

    au, av, aw = delta.add
    ru, rv = delta.remove
    wu, wv, ww = delta.reweight
    for name, us, vs in (("add", au, av), ("remove", ru, rv),
                         ("reweight", wu, wv)):
        if us.size and not (np.all((us >= 0) & (us < n))
                            and np.all((vs >= 0) & (vs < n))):
            raise ValueError(f"{name} vertex ids out of range [0, {n})")

    if delta.symmetrize:
        au, av, aw = (np.concatenate([au, av]), np.concatenate([av, au]),
                      np.concatenate([aw, aw]))
        ru, rv = np.concatenate([ru, rv]), np.concatenate([rv, ru])
        wu, wv, ww = (np.concatenate([wu, wv]), np.concatenate([wv, wu]),
                      np.concatenate([ww, ww]))

    # each remove/reweight must target a distinct directed slot (this
    # rejects symmetrized self-loop removes: expand those to a
    # symmetrize=False delta)
    key = np.concatenate([ru, wu]) * np.int64(n) + np.concatenate([rv, wv])
    if np.unique(key).size != key.size:
        raise ValueError("duplicate remove/reweight target in one delta "
                         "(after symmetrize expansion)")

    rm_slots = np.asarray(
        [_find_slot(row_ptr, d, int(u), int(v)) for u, v in zip(ru, rv)],
        np.int64)
    rw_kinds = np.zeros(wu.size, np.int8)
    for i, (u, v, new_w) in enumerate(zip(wu, wv, ww)):
        slot = _find_slot(row_ptr, d, int(u), int(v))
        old = w[slot]
        rw_kinds[i] = (KIND_INCREASE if new_w > old
                       else KIND_DECREASE if new_w < old else KIND_SAME)
        w[slot] = new_w

    applied = AppliedDelta(
        src=np.concatenate([au, ru, wu]).astype(np.int64),
        dst=np.concatenate([av, rv, wv]).astype(np.int64),
        kind=np.concatenate([np.full(au.size, KIND_ADD, np.int8),
                             np.full(ru.size, KIND_REMOVE, np.int8),
                             rw_kinds]))

    keep = np.ones(s.size, bool)
    keep[rm_slots] = False
    s2 = np.concatenate([s[keep], au])
    d2 = np.concatenate([d[keep], av])
    w2 = np.concatenate([w[keep], aw]).astype(np.float32)

    # build_csr's stable lexsort((w2, s2)), computed row by row: a stable
    # sort by source leaves each row's entries in input order, and only a
    # row with an edit needs its stable sort by weight (an untouched row
    # is already sorted, so the stable sort would leave it as it is)
    order = np.argsort(s2, kind="stable")
    deg = np.bincount(s2, minlength=n).astype(np.int32)
    rp = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    for u in np.unique(np.concatenate([ru, wu, au])):
        lo, hi = rp[u], rp[u + 1]
        row = order[lo:hi]
        order[lo:hi] = row[np.argsort(w2[row], kind="stable")]
    s2, d2, w2 = s2[order], d2[order], w2[order]
    new_host = HostGraph(
        n=n, src=s2.astype(np.int32), dst=d2.astype(np.int32), w=w2,
        row_ptr=rp.astype(np.int32), deg=deg,
        rtow=graph._weight_quantile_lut(w2.astype(np.float64)),
        max_w=float(w2.max()) if w2.size else 0.0)
    return new_host, applied


def _slab_of(new_host: HostGraph, b: int, bv: int, nb: int, te: int):
    """Source block ``b``'s slab rebuilt from the host CSR, as
    :func:`~repro_torch.core.graph.build_blocked` lays it out: numpy
    ``(src, dst, w, tile_dst, tile_first, nonempty, tiles_per, index)``
    with global source ids (padding from the block's first id), tile ids
    local to the slab and the index over the block's ``bv`` sources."""
    lo_v, hi_v = b * bv, min(b * bv + bv, new_host.n)
    rp = new_host.row_ptr
    e0, e1 = int(rp[lo_v]), int(rp[hi_v])
    local = (np.asarray(new_host.src[e0:e1], np.int64) - lo_v)
    s, d, w, td, tf, ne, tiles_per, _, index = graph._bucket(
        np.zeros(local.shape, np.int64), local.astype(np.int32),
        np.asarray(new_host.dst[e0:e1], np.int32),
        np.asarray(new_host.w[e0:e1], np.float32), n_src_blocks=1,
        n_dst_blocks=nb, block_v=bv, tile_e=te)
    return (s + np.int32(lo_v), d, w, td, tf, ne[0], tiles_per[0], index)


def patch_blocked_with(layout: BlockedGraph, old_host: HostGraph,
                       new_host: HostGraph,
                       applied: AppliedDelta) -> BlockedGraph:
    """Patch a whole-graph blocked layout given an already-patched host.

    The result equals ``build_blocked(new_host)`` at the layout's
    geometry, field for field, ``index`` included.  Where a shape is
    unchanged the layout's device tensors are written in place: the
    returned layout shares them, and ``layout`` itself must not be used
    afterwards (clone its tensors first to keep it).  Where a slab's
    tile count changed, new tensors hold the tiles and the tile index.
    The package caches no CUDA graph over a layout: a graph a caller
    captured over ``layout`` still reads valid memory after a patch in
    place, but must be captured again after a patch that changed a tile
    count.  The kernels' scratch is keyed by tile and destination counts
    (``kernels/edge_relax/ops.py``), so a patch in place reuses it.
    """
    if layout.n != new_host.n:
        raise ValueError(f"layout has n={layout.n}, the host n={new_host.n}")
    bv, te, nb = layout.block_v, layout.tile_e, layout.n_blocks
    n = new_host.n
    changed = applied.kind != KIND_SAME
    dev = layout.src.device
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rp_old = np.asarray(old_host.row_ptr, np.int64)
    slab_ptr = np.asarray(layout.slab_ptr, np.int64)
    src, dst, w = layout.src, layout.dst, layout.w
    tile_dst, tile_first = layout.tile_dst, layout.tile_first
    vt_ptr, vt_tile, forced = layout.index
    tiles_moved = False

    for b in np.unique(applied.src[changed] // bv):
        b = int(b)
        s, d, ww, td, tf, ne, tp_new, ix = _slab_of(new_host, b, bv, nb, te)
        lo_v = b * bv
        o0, o1 = rp_old[lo_v], rp_old[min(lo_v + bv, n)]
        tp_old = -(-np.bincount(
            np.asarray(old_host.dst[o0:o1], np.int64) // bv,
            minlength=nb) // te)
        t0, t1 = int(slab_ptr[b]), int(slab_ptr[b + 1])
        shift = td.size - (t1 - t0)
        if np.array_equal(tp_old, tp_new) and shift == 0:
            # tile padding absorbs the edit: per-bucket tile counts are
            # unchanged, so tile_dst/tile_first/bucket_nonempty are too,
            # and only the touched buckets' slots move
            tile_ptr = np.zeros(nb + 1, np.int64)
            np.cumsum(tp_new, out=tile_ptr[1:])
            in_b = changed & (applied.src // bv == b)
            for db in np.unique(applied.dst[in_b] // bv):
                a0, a1 = tile_ptr[db] * te, tile_ptr[db + 1] * te
                g0 = t0 * te
                for dev_t, host in ((src, s), (dst, d), (w, ww)):
                    dev_t[g0 + a0:g0 + a1] = put(host[a0:a1])
        elif shift == 0:
            for dev_t, host, k in ((src, s, te), (dst, d, te), (w, ww, te),
                                   (tile_dst, td, 1), (tile_first, tf, 1)):
                dev_t[t0 * k:t1 * k] = put(host)
            tiles_moved = True
        else:
            src, dst, w, tile_dst, tile_first = (
                torch.cat([x[:t0 * k], put(host), x[t1 * k:]])
                for x, host, k in ((src, s, te), (dst, d, te), (w, ww, te),
                                   (tile_dst, td, 1), (tile_first, tf, 1)))
            slab_ptr[b + 1:] += shift
            tiles_moved = True
        layout.bucket_nonempty[b] = put(ne)

        # the block's sources' index entries; those of later blocks keep
        # their entries, shifted with their slabs' tiles
        start, end = vt_ptr[[lo_v, lo_v + bv]].tolist()
        seg_ptr = ix.vt_ptr.astype(np.int64) + start
        seg_tile = ix.vt_tile + np.int32(t0)
        grow = int(ix.vt_ptr[-1]) - (end - start)
        if grow == 0 and shift == 0:
            vt_tile[start:end] = put(seg_tile)
        else:
            vt_tile = torch.cat([vt_tile[:start], put(seg_tile),
                                 vt_tile[end:] + shift])
        vt_ptr[lo_v:lo_v + bv + 1] = put(seg_ptr.astype(np.int32))
        vt_ptr[lo_v + bv + 1:] += grow

    if tiles_moved:
        new_forced = torch.nonzero(tile_first).reshape(-1).to(torch.int32)
        if new_forced.shape == forced.shape:
            forced.copy_(new_forced)
        else:
            forced = new_forced
    layout.deg[:n] = put(np.asarray(new_host.deg, np.int32))
    sb_counts = np.bincount(np.asarray(new_host.src, np.int64) // bv,
                            minlength=nb)
    dense = nb * int(np.maximum(-(-sb_counts // te), 1).sum())
    return dataclasses.replace(
        layout, dense_grid_tiles=dense,
        slab_ptr=tuple(int(x) for x in slab_ptr), src=src, dst=dst, w=w,
        tile_dst=tile_dst, tile_first=tile_first,
        index=TileIndex(vt_ptr=vt_ptr, vt_tile=vt_tile, forced=forced))


def patch_blocked(layout: BlockedGraph, delta: EdgeDelta, *,
                  host: HostGraph):
    """Patch a blocked layout; returns ``(new_layout, new_host, applied)``.

    ``host`` is the HostGraph the layout was built from: slab data alone
    cannot reproduce the CSR tie order the buckets inherit, so the patch
    runs through :func:`patch_host` first.  ``layout``'s tensors are
    written in place where their shapes allow (:func:`patch_blocked_with`).
    """
    new_host, applied = patch_host(host, delta)
    return patch_blocked_with(layout, host, new_host, applied), \
        new_host, applied


def patch_sharded_with(sg: "distributed.ShardedGraph", new_host: HostGraph,
                       applied: AppliedDelta) -> "distributed.ShardedGraph":
    """Patch the per-shard edge slabs given an already-patched host (a new
    :class:`~repro_torch.core.distributed.ShardedGraph`; ``sg`` is left
    as it was)."""
    p, e_max = sg.src.shape
    block = int(sg.deg.shape[1])
    n = new_host.n
    rp = np.asarray(new_host.row_ptr, np.int64)
    counts = np.bincount(np.asarray(new_host.src, np.int64) // block,
                         minlength=p)
    if int(counts.max() if counts.size else 0) > e_max:
        # a shard outgrew its slab: widen every row (shard_graph's
        # uniform e_max keeps the stacked table rectangular)
        e_max = max(int(counts.max()), 1)
        s2 = np.zeros((p, e_max), np.int32)
        d2 = np.zeros((p, e_max), np.int32)
        w2 = np.full((p, e_max), np.inf, np.float32)
        for q in range(p):
            s2[q, :] = q * block
        shards = np.arange(p)
    else:
        s2 = np.asarray(sg.src).copy()
        d2 = np.asarray(sg.dst).copy()
        w2 = np.asarray(sg.w).copy()
        changed = applied.kind != KIND_SAME
        shards = np.unique(applied.src[changed] // block)
    for q in shards:
        q = int(q)
        lo_v = q * block
        if lo_v >= n:
            continue
        e0, e1 = rp[lo_v], rp[min(lo_v + block, n)]
        c = int(e1 - e0)
        # shard_graph's stable owner sort preserves CSR order, so the
        # shard's slab is exactly the host CSR slice plus padding
        s2[q, :c] = new_host.src[e0:e1]
        d2[q, :c] = new_host.dst[e0:e1]
        w2[q, :c] = new_host.w[e0:e1]
        s2[q, c:] = q * block
        d2[q, c:] = 0
        w2[q, c:] = np.inf
    deg = np.zeros(p * block, np.int32)
    deg[:n] = new_host.deg
    return distributed.ShardedGraph(
        src=s2, dst=d2, w=w2, deg=deg.reshape(p, block),
        rtow=np.asarray(new_host.rtow, np.float32),
        n_edges2=int(new_host.m), n_true=sg.n_true)


def patch_sharded(sg: "distributed.ShardedGraph", delta: EdgeDelta, *,
                  host: HostGraph):
    """Patch sharded slabs; returns ``(new_sg, new_host, applied)``."""
    new_host, applied = patch_host(host, delta)
    return patch_sharded_with(sg, new_host, applied), new_host, applied
