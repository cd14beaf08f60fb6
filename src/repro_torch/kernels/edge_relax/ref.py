"""Plain PyTorch versions of the edge_relax kernel and its prepass.

``edge_relax_ref`` is the kernel's contract written with ``scatter_reduce``;
``schedule_tiles`` is the reference's frontier-compaction prepass.  The
wrapper in :mod:`.ops` runs them for CPU tensors, the tests hold them
against the JAX package, and ``chip_smoke.py`` holds the CUDA kernel
against them on the card.  Both work on any device.
"""
from __future__ import annotations

import torch

INT_MAX = 2 ** 31 - 1


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


def edge_relax_ref(dist_block, frontier_block, src_local, dst_local, w,
                   lb, ub, *, n_out: int):
    """Returns ``(vals, winners)``: per destination over ``n_out``, the
    minimum in-window candidate ``dist[src] + w`` of a frontier source,
    and the smallest source id achieving it (``(inf, INT_MAX)`` where no
    candidate exists).  Source ids index ``dist_block``: block-local for
    one slab, global for a concatenated slab set."""
    src = src_local.long()
    dst = dst_local.long()
    cand = dist_block[src] + w
    ok = (frontier_block[src] > 0) & (cand >= lb) & (cand < ub)
    cand = torch.where(ok, cand, torch.inf)
    best = torch.full((n_out,), torch.inf, dtype=torch.float32,
                      device=w.device).scatter_reduce_(0, dst, cand, "amin")
    win = torch.where(ok & (cand <= best[dst]), src_local.to(torch.int32),
                      INT_MAX)
    winner = torch.full((n_out,), INT_MAX, dtype=torch.int32,
                        device=w.device).scatter_reduce_(0, dst, win, "amin")
    return best, winner
