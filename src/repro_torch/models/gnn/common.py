"""Shared GNN machinery, the port's copy of ``repro.models.gnn.common``:
segment message passing, MLPs, graph batches.

Message passing is a gather by ``senders``, a transform, and a
``segment_sum/max/min`` by ``receivers``.  The segment sums are
``index_add`` into zeros (on the card its atomics add in no fixed
order, so sums agree with the reference by tolerance, not bit for bit);
the maxima and minima are ``scatter_reduce`` into a tensor that starts
at ``-inf``/``+inf`` without it taking part, so that an empty segment
gets the identity, as ``jax.ops.segment_max/min`` give (PNA clips it).
No kernel of the reference runs here: its gathers and segment ops are
outside any Pallas kernel.

Graph batches are disjoint unions (molecule batches are flattened with
node offsets); ``graph_ids`` drives segment readouts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...parallel.dtensor_ops import constrain, is_dtensor
from ..layers import dense_init, softmax_cross_entropy


@dataclasses.dataclass
class GraphBatch:
    node_feat: torch.Tensor                       # [N, F]
    senders: torch.Tensor                         # [E] int
    receivers: torch.Tensor                       # [E] int
    edge_feat: Optional[torch.Tensor]             # [E, Fe] or None
    graph_ids: torch.Tensor                       # [N] int (graph membership)
    n_graphs: int = 1
    labels: Optional[torch.Tensor] = None         # [N] or [G]
    pos: Optional[torch.Tensor] = None            # [N, 3] (geometric models)
    edge_mask: Optional[torch.Tensor] = None      # [E] bool (padding)
    triplet_kj: Optional[torch.Tensor] = None     # [T] edge index (k->j)
    triplet_ji: Optional[torch.Tensor] = None     # [T] edge index (j->i)
    triplet_mask: Optional[torch.Tensor] = None   # [T] bool
    # sharding context (DeviceMesh, axis-name tuple) for full-batch cells;
    # None on one device
    shard_ctx: Optional[tuple] = None

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GraphBatch":
        """The batch with every array field (tensors or numpy arrays) a
        tensor on ``device``; DTensor fields stay where they are."""
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if is_dtensor(v):
                continue
            if isinstance(v, (torch.Tensor, np.ndarray)):
                moved[f.name] = torch.as_tensor(v, device=device)
        return dataclasses.replace(self, **moved)


def shard0(gb: GraphBatch, x):
    """Constrain dim 0 of ``x`` (edges/nodes/triplets) to the graph
    sharding: a DTensor is redistributed to dim 0 split over the
    context's axes; on one device, or for a plain tensor, nothing."""
    if gb.shard_ctx is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh, axes = gb.shard_ctx
    return constrain(x, tuple(Shard(0) if n in axes else Replicate()
                              for n in mesh.mesh_dim_names))


def _index(ids, like):
    """``ids`` as the int64 index ``scatter_reduce`` takes, broadcast to
    ``like``'s shape."""
    ids = ids.long().view(-1, *([1] * (like.dim() - 1)))
    return ids.expand_as(like)


def seg_sum(x, ids, n):
    return torch.zeros((n, *x.shape[1:]), dtype=x.dtype,
                       device=x.device).index_add(0, ids, x)


def seg_mean(x, ids, n):
    s = seg_sum(x, ids, n)
    c = seg_sum(torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device),
                ids, n)
    return s / torch.clamp(c, min=1.0)


def _seg_extreme(x, ids, n, reduce, identity):
    out = torch.full((n, *x.shape[1:]), identity, dtype=x.dtype,
                     device=x.device)
    return out.scatter_reduce(0, _index(ids, x), x, reduce,
                              include_self=False)


def seg_max(x, ids, n):
    """Segment maximum; ``-inf`` for an empty segment, as JAX's."""
    return _seg_extreme(x, ids, n, "amax", float("-inf"))


def seg_min(x, ids, n):
    """Segment minimum; ``+inf`` for an empty segment, as JAX's."""
    return _seg_extreme(x, ids, n, "amin", float("inf"))


def seg_softmax(logits, ids, n):
    """Numerically-stable softmax over segments (edge-attention)."""
    m = seg_max(logits, ids, n)
    z = torch.exp(logits - m[ids])
    s = seg_sum(z, ids, n)
    return z / torch.clamp(s[ids], min=1e-9)


def in_degree(receivers, n, edge_mask=None, dtype=torch.float32):
    ones = torch.ones(receivers.shape, dtype=dtype, device=receivers.device)
    if edge_mask is not None:
        ones = torch.where(edge_mask, ones, 0)
    return seg_sum(ones, receivers, n)


def mlp_init(gen: torch.Generator, dims, dtype=torch.float32, *, lead=()):
    """``{"w": [d_i x d_i+1 ...], "b": [zeros ...]}``; ``lead`` prepends
    stacking dimensions (one MLP per layer)."""
    return {
        "w": [dense_init(gen, dims[i], dims[i + 1], dtype, lead=lead)
              for i in range(len(dims) - 1)],
        "b": [torch.zeros((*lead, dims[i + 1]), dtype=dtype,
                          device=gen.device) for i in range(len(dims) - 1)],
    }


def mlp_apply(p, x, act=F.relu, final_act=False):
    n = len(p["w"])
    for i in range(n):
        x = x @ p["w"][i] + p["b"][i]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def masked_edges(gb: GraphBatch, x_e):
    if gb.edge_mask is not None:
        return torch.where(gb.edge_mask[:, None], x_e, 0.0)
    return x_e


def node_ce_loss(logits, labels, mask=None):
    loss = softmax_cross_entropy(logits, labels)
    if mask is not None:
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()


def run_layer(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant:
    activations recomputed in backward, the reference's
    ``jax.checkpoint``) where ``remat`` and grad is on."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)
