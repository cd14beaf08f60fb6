"""PNA (Principal Neighbourhood Aggregation) — arXiv:2004.05718, the
port's copy of ``repro.models.gnn.pna``.

Four aggregators (mean/max/min/std) x three degree scalers (identity,
amplification, attenuation) -> 12-way concat -> linear.  Configuration:
4 layers, d_hidden=75.  Layer 0 (d_in) separate; the uniform layers are
stacked and run as a Python loop (the reference's ``lax.scan``).

An isolated node's max and min segments are empty: ``seg_max``/
``seg_min`` give ``-inf``/``+inf`` there, as JAX does, and the clip to
``±3e30`` below turns them finite, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..layers import dense_init
from .common import (GraphBatch, mlp_apply, mlp_init, run_layer,
                     seg_sum, shard0)
from .sharded_ops import gather0, scatter_max0, scatter_sum0
from ...train.tree import tree_map


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 75
    n_classes: int = 16
    avg_log_deg: float = 2.0   # delta: E[log(d+1)] over the training graphs
    graph_level: bool = False
    dtype: object = torch.float32
    remat: bool = False


def _layer_init(gen, d_in, d_hidden, dtype, lead=()):
    return {
        "w_pre": dense_init(gen, 2 * d_in, d_hidden, dtype, lead=lead),
        "w_post": dense_init(gen, 12 * d_hidden + d_in, d_hidden, dtype,
                             lead=lead),
    }


def init_params(cfg: PNAConfig, gen: torch.Generator):
    """``{"layer0": {"w_pre", "w_post"}, "layers": the same stacked over
    the other ``n_layers - 1``, "head"}``, drawn on ``gen``'s device."""
    return {"layer0": _layer_init(gen, cfg.d_in, cfg.d_hidden, cfg.dtype),
            "layers": _layer_init(gen, cfg.d_hidden, cfg.d_hidden,
                                  cfg.dtype, lead=(cfg.n_layers - 1,)),
            "head": mlp_init(gen, [cfg.d_hidden, cfg.n_classes], cfg.dtype)}


def _aggregate(ctx, msg, receivers, n, edge_mask, deg):
    """One scatter-sum carries ``[msg, msg^2]``, one scatter-max
    ``[msg, -msg]`` (min = -max(-x)), as in the reference."""
    if edge_mask is not None:
        msg = torch.where(edge_mask[:, None], msg, 0.0)
    d = msg.shape[-1]
    dt = msg.dtype
    denom = torch.clamp(deg, min=1.0).to(dt)
    sums = scatter_sum0(ctx, torch.cat([msg, msg * msg], -1), receivers, n)
    mean = sums[:, :d] / denom
    sq = sums[:, d:] / denom
    std = torch.sqrt(torch.clamp(sq - mean * mean,
                                 min=torch.tensor(1e-8, dtype=dt).item()))
    big = torch.tensor(3e30, dtype=dt).item()
    mm_in = torch.cat([msg, -msg], -1)
    if edge_mask is not None:
        mm_in = torch.where(edge_mask[:, None], mm_in, -big)
    mm = scatter_max0(ctx, mm_in, receivers, n)
    mx = torch.clamp(mm[:, :d], -big, big)
    mn = torch.clamp(-mm[:, d:], -big, big)
    return [mean, mx, mn, std]


def forward(cfg: PNAConfig, params, gb: GraphBatch):
    h = gb.node_feat.to(cfg.dtype)
    n = h.shape[0]
    ones = torch.ones((gb.receivers.shape[0], 1), dtype=torch.float32,
                      device=h.device)
    if gb.edge_mask is not None:
        ones = torch.where(gb.edge_mask[:, None], ones, 0.0)
    deg = scatter_sum0(gb.shard_ctx, ones, gb.receivers, n)
    log_d = torch.log1p(deg[:, 0])[:, None].to(cfg.dtype)
    avg = torch.tensor(cfg.avg_log_deg, dtype=cfg.dtype, device=h.device)
    s_amp = log_d / avg
    s_att = avg / torch.clamp(log_d, min=torch.tensor(
        1e-6, dtype=cfg.dtype).item())

    def layer(h, lp):
        msg_in = torch.cat([gather0(gb.shard_ctx, h, gb.senders),
                            gather0(gb.shard_ctx, h, gb.receivers)], -1)
        msg = F.relu(msg_in @ lp["w_pre"])
        aggs = _aggregate(gb.shard_ctx, msg, gb.receivers, n, gb.edge_mask,
                          deg)
        scaled = []
        for a in aggs:
            scaled += [a, a * s_amp, a * s_att]
        z = torch.cat(scaled + [h], -1)
        return shard0(gb, F.relu(z @ lp["w_post"]))

    h = layer(h, params["layer0"])
    for i in range(cfg.n_layers - 1):
        h = run_layer(layer, cfg.remat, h,
                      tree_map(lambda t: t[i], params["layers"]))
    if cfg.graph_level:
        pooled = seg_sum(h, gb.graph_ids, gb.n_graphs)
        return mlp_apply(params["head"], pooled)
    return mlp_apply(params["head"], h)
