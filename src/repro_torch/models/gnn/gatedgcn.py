"""GatedGCN — arXiv:1711.07553 / benchmarking-gnns (arXiv:2003.00982),
the port's copy of ``repro.models.gnn.gatedgcn``.

Edge-gated message passing with explicit edge features:

    eta_ij  = sigma(A h_i + B h_j + C e_ij)
    e_ij'   = A h_i + B h_j + C e_ij            (edge update, pre-sigma)
    h_i'    = U h_i + sum_j eta_ij * (V h_j) / (sum_j eta_ij + eps)

Residual connections + LayerNorm, as the reference.  Configuration: 16
layers, d_hidden=70, stacked layer parameters run as a Python loop over
the leading axis (the reference's ``lax.scan``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..layers import dense_init, layer_norm
from .common import (GraphBatch, mlp_apply, mlp_init, run_layer,
                     seg_sum, shard0)
from .sharded_ops import gather0, scatter_sum0
from ...train.tree import tree_map


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 70
    d_edge_in: int = 8
    n_classes: int = 16
    graph_level: bool = False
    dtype: object = torch.float32
    remat: bool = False


def init_params(cfg: GatedGCNConfig, gen: torch.Generator):
    """``{"embed_h", "embed_e", "layers": {A, B, C, U, V, ln_h, lb_h, ln_e,
    lb_e} stacked over the layers, "head"}``, drawn on ``gen``'s device."""
    d, dev, lead = cfg.d_hidden, gen.device, (cfg.n_layers,)
    layers = {k: dense_init(gen, d, d, cfg.dtype, lead=lead)
              for k in ("A", "B", "C", "U", "V")}
    for k, fill in (("ln_h", 1.0), ("lb_h", 0.0), ("ln_e", 1.0),
                    ("lb_e", 0.0)):
        layers[k] = torch.full((*lead, d), fill, dtype=cfg.dtype, device=dev)
    return {
        "embed_h": dense_init(gen, cfg.d_in, d, cfg.dtype),
        "embed_e": dense_init(gen, cfg.d_edge_in, d, cfg.dtype),
        "layers": layers,
        "head": mlp_init(gen, [d, cfg.n_classes], cfg.dtype),
    }


def forward(cfg: GatedGCNConfig, params, gb: GraphBatch):
    n = gb.node_feat.shape[0]
    h = shard0(gb, gb.node_feat.to(cfg.dtype) @ params["embed_h"])
    if gb.edge_feat is not None:
        e = gb.edge_feat.to(cfg.dtype) @ params["embed_e"]
    else:
        e = torch.zeros((gb.senders.shape[0], cfg.d_hidden), dtype=cfg.dtype,
                        device=h.device)
    e = shard0(gb, e)

    def layer(h, e, lp):
        hi = gather0(gb.shard_ctx, h, gb.receivers)
        hj = gather0(gb.shard_ctx, h, gb.senders)
        e_new = hi @ lp["A"] + hj @ lp["B"] + e @ lp["C"]
        eta = torch.sigmoid(e_new)
        if gb.edge_mask is not None:
            eta = torch.where(gb.edge_mask[:, None], eta, 0.0)
        num = scatter_sum0(gb.shard_ctx, eta * (hj @ lp["V"]), gb.receivers,
                           n)
        den = scatter_sum0(gb.shard_ctx, eta, gb.receivers, n) + 1e-6
        h2 = shard0(gb, h + F.relu(layer_norm(h @ lp["U"] + num / den,
                                              lp["ln_h"], lp["lb_h"])))
        e2 = shard0(gb, e + F.relu(layer_norm(e_new, lp["ln_e"],
                                              lp["lb_e"])))
        return h2, e2

    for i in range(cfg.n_layers):
        h, e = run_layer(layer, cfg.remat, h, e,
                         tree_map(lambda t: t[i], params["layers"]))
    if cfg.graph_level:
        pooled = seg_sum(h, gb.graph_ids, gb.n_graphs)
        return mlp_apply(params["head"], pooled)
    return mlp_apply(params["head"], h)
