"""Gather and segment-reduce primitives for full-batch GNNs, the port's
copy of ``repro.models.gnn.sharded_ops``.

With ``ctx is None`` (one device) they are the plain ops of
:mod:`.common`.  With ``ctx = (mesh, axes)`` (a ``DeviceMesh`` and the
names of the mesh dims the node and edge arrays are split over, row
major, the first outermost) every op runs on this rank's shards through
``torch.distributed`` collectives over the mesh's groups, so that state
stays sharded:

* ``gather0``      — all-gather the (small) node table once, index
                     locally: transient = one full node table per rank.
* ``scatter_sum0`` — local full-size accumulation + reduce-scatter:
                     returns a node-sharded result.
* ``scatter_max0/min0`` — the same pattern through a *hierarchical*
                     all-to-all reduce: one k-way exchange per mesh axis,
                     outermost first (the SSSP v2 exchange reused for GNN
                     aggregation).

The inputs are DTensors (their local shards are used and the result is
a DTensor split the same way), or plain tensors taken as this rank's
shards (the result is this rank's shard).  The collectives are
``torch.distributed._functional_collectives``' autograd versions, so
each op is differentiable through its collectives' transposes, as the
reference's.
"""
from __future__ import annotations

import torch

from ...parallel.dtensor_ops import is_dtensor, wrap
from .common import seg_max, seg_min, seg_sum


def _placements(mesh, axes):
    """Dim 0 split over ``axes`` (in mesh order), other mesh dims whole."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    for a in axes:
        if a not in names:
            raise ValueError(f"axis {a!r} is not a dim of the mesh {names}")
    order = [names.index(a) for a in axes]
    if order != sorted(order):
        raise ValueError(f"axes {tuple(axes)} are not in mesh order {names}")
    return tuple(Shard(0) if n in axes else Replicate() for n in names)


def _local(ctx, *xs):
    """The local shards of ``xs`` (DTensors redistributed to dim 0 over
    the axes first), and the placements to wrap results in (``None``
    for plain inputs)."""
    mesh, axes = ctx
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError("shard_ctx is (DeviceMesh, axis names), got a "
                        f"{type(mesh).__name__}")
    if not any(is_dtensor(x) for x in xs):
        return xs, None
    places = _placements(mesh, axes)
    out = []
    for x in xs:
        if not is_dtensor(x):
            raise TypeError("sharded GNN ops take all DTensors or all "
                            "plain tensors")
        out.append(x.redistribute(mesh, places).to_local())
    return tuple(out), places


def _dim(mesh, a):
    return tuple(mesh.mesh_dim_names).index(a)


def _funcol(new: str, old: str):
    """A functional collective by its newer name, or its older one."""
    from torch.distributed import _functional_collectives as funcol
    return getattr(funcol, new, None) or getattr(funcol, old)


def _all_gather0(ctx, x):
    """Dim 0 gathered over every axis, innermost first (row major)."""
    gather = _funcol("all_gather_single_autograd",
                     "all_gather_tensor_autograd")
    mesh, axes = ctx
    for a in reversed(tuple(axes)):
        x = gather(x, 0, (mesh, _dim(mesh, a)))
    return x


def _reduce_scatter0(ctx, x):
    """Dim 0 summed and scattered over every axis, outermost first."""
    scatter = _funcol("reduce_scatter_single_autograd",
                      "reduce_scatter_tensor_autograd")
    mesh, axes = ctx
    for a in axes:
        x = scatter(x, "sum", 0, (mesh, _dim(mesh, a)))
    return x


def _wrap(ctx, places, local, global_rows):
    if places is None:
        return local
    return wrap(local, ctx[0], places, (global_rows, *local.shape[1:]))


def gather0(ctx, table, idx):
    """table ``[N, F]`` (dim 0 sharded), idx ``[M]`` (dim 0 sharded) ->
    ``[M, F]``."""
    if ctx is None:
        return table.index_select(0, idx)
    (tl, il), places = _local(ctx, table, idx)
    full = _all_gather0(ctx, tl)
    return _wrap(ctx, places, full.index_select(0, il), idx.shape[0])


def scatter_sum0(ctx, values, idx, n):
    """values ``[M, F]`` + idx ``[M]`` -> ``[n, F]``, all dim 0 sharded."""
    if ctx is None:
        return seg_sum(values, idx, n)
    (vl, il), places = _local(ctx, values, idx)
    return _wrap(ctx, places, _reduce_scatter0(ctx, seg_sum(vl, il, n)), n)


def _scatter_extreme(ctx, values, idx, n, kind):
    """Reduce-scatter-{max,min} via a hierarchical per-axis all-to-all:
    one k-way exchange per mesh axis (outermost first) instead of a
    single P-way exchange."""
    from torch.distributed import _functional_collectives as funcol

    op = seg_max if kind == "max" else seg_min
    if ctx is None:
        return op(values, idx, n)
    mesh, axes = ctx
    (vl, il), places = _local(ctx, values, idx)
    part = op(vl, il, n)                              # [n, F] local partial
    for a in axes:                                    # row-major = P(axes)
        k = mesh.size(_dim(mesh, a))
        recv = funcol.all_to_all_single_autograd(
            part.contiguous(), None, None, (mesh, _dim(mesh, a)))
        recv = recv.reshape(k, part.shape[0] // k, *part.shape[1:])
        part = recv.amax(0) if kind == "max" else recv.amin(0)
    return _wrap(ctx, places, part, n)


def scatter_max0(ctx, values, idx, n):
    return _scatter_extreme(ctx, values, idx, n, "max")


def scatter_min0(ctx, values, idx, n):
    return _scatter_extreme(ctx, values, idx, n, "min")
