"""Gather and segment-reduce primitives for full-batch GNNs, the port's
copy of ``repro.models.gnn.sharded_ops`` on one device.

The reference wraps each op in ``shard_map`` for a sharded node table
(an all-gather, a ``psum_scatter``, an all-to-all reduce) when
``gb.shard_ctx`` holds a mesh; its only users are the compile-only
many-chip cells of ``launch/cells.py``.  Here ``ctx`` is ``None`` (one
device) and the ops are the plain ones of :mod:`.common`; a mesh raises
(ROADMAP.md, queue 1 item 10).
"""
from __future__ import annotations

from .common import _UNSHARDED, seg_max, seg_min, seg_sum


def _one_device(ctx):
    if ctx is not None:
        raise NotImplementedError(_UNSHARDED)


def gather0(ctx, table, idx):
    """table ``[N, F]``, idx ``[M]`` -> ``[M, F]``."""
    _one_device(ctx)
    return table.index_select(0, idx)


def scatter_sum0(ctx, values, idx, n):
    """values ``[M, F]`` + idx ``[M]`` -> ``[n, F]``."""
    _one_device(ctx)
    return seg_sum(values, idx, n)


def scatter_max0(ctx, values, idx, n):
    _one_device(ctx)
    return seg_max(values, idx, n)


def scatter_min0(ctx, values, idx, n):
    _one_device(ctx)
    return seg_min(values, idx, n)
