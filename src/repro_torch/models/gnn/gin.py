"""GIN (Graph Isomorphism Network) — arXiv:1810.00826, the port's copy of
``repro.models.gnn.gin``.

``h_v' = MLP((1 + eps) h_v + sum_{u in N(v)} h_u)`` with learnable eps
(GIN-eps).  Configuration gin-tu: 5 layers, d_hidden=64, sum aggregator.

Layer 0 (d_in -> d_hidden) is separate; the remaining uniform layers are
stacked parameters (the reference's ``lax.scan``), run here as a Python
loop over the leading axis.
"""
from __future__ import annotations

import dataclasses

import torch

from .common import (GraphBatch, masked_edges, mlp_apply,
                     mlp_init, run_layer, seg_sum, shard0)
from .sharded_ops import gather0, scatter_sum0
from ...train.tree import tree_map


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 64
    n_classes: int = 16
    graph_level: bool = False
    dtype: object = torch.float32
    remat: bool = False


def init_params(cfg: GINConfig, gen: torch.Generator):
    """``{"layer0": {"mlp", "eps"}, "layers": {"mlp", "eps"} stacked over
    the other ``n_layers - 1``, "head"}``, drawn on ``gen``'s device."""
    d, dev = cfg.d_hidden, gen.device
    rest = (cfg.n_layers - 1,)
    return {
        "layer0": {"mlp": mlp_init(gen, [cfg.d_in, d, d], cfg.dtype),
                   "eps": torch.zeros((), dtype=cfg.dtype, device=dev)},
        "layers": {"mlp": mlp_init(gen, [d, d, d], cfg.dtype, lead=rest),
                   "eps": torch.zeros(rest, dtype=cfg.dtype, device=dev)},
        "head": mlp_init(gen, [d, cfg.n_classes], cfg.dtype),
    }


def forward(cfg: GINConfig, params, gb: GraphBatch):
    h = gb.node_feat.to(cfg.dtype)
    n = h.shape[0]

    def layer(h, lp):
        msg = masked_edges(gb, gather0(gb.shard_ctx, h, gb.senders))
        agg = scatter_sum0(gb.shard_ctx, msg, gb.receivers, n)
        return shard0(gb, mlp_apply(lp["mlp"], (1.0 + lp["eps"]) * h + agg))

    h = layer(h, params["layer0"])
    for i in range(cfg.n_layers - 1):
        h = run_layer(layer, cfg.remat, h,
                      tree_map(lambda t: t[i], params["layers"]))
    if cfg.graph_level:
        pooled = seg_sum(h, gb.graph_ids, gb.n_graphs)
        return mlp_apply(params["head"], pooled)
    return mlp_apply(params["head"], h)
