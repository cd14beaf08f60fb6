"""The paper's technique as a first-class framework feature: EIC SSSP
distances as GNN positional features (anchor-distance encoding), on the
card.

Runs the EIC engine from K anchor vertices (one batched ``SolveSpec``,
``repro_torch.models.gnn.anchors``), attaches the K-dim distance profile
to each node's features, and trains a GIN classifier — the graph
substrate (CSR, segment message passing) is shared between the SSSP core
and the GNN model zoo.

    PYTHONPATH=src python examples/torch/gnn_sssp_features.py \\
        [--device cuda|cpu]

The same flow and lines as ``examples/gnn_sssp_features.py``, on
``--device`` (default ``cuda``; without a card that fails).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import torch  # noqa: E402

from repro_torch.core.sssp import resolve_device  # noqa: E402
from repro_torch.data.generators import kronecker  # noqa: E402
from repro_torch.models.gnn import gin  # noqa: E402
from repro_torch.models.gnn.anchors import anchor_distance_features  # noqa: E402
from repro_torch.models.gnn.common import GraphBatch  # noqa: E402
from repro_torch.train import loop as train_loop, optimizer as opt_mod  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = kronecker(10, 8, seed=3)
    feats, anchors = anchor_distance_features(g, k_anchors=8, device=device)
    print(f"graph |V|={g.n} |E|={g.m//2}; anchors={list(anchors)}")

    # labels: nearest anchor (a task the distance features solve exactly,
    # and raw structure alone cannot)
    labels = feats.argmax(1).to(torch.int32)

    gb = GraphBatch(node_feat=feats,
                    senders=torch.from_numpy(g.src).to(device),
                    receivers=torch.from_numpy(g.dst).to(device),
                    edge_feat=None,
                    graph_ids=torch.zeros(g.n, dtype=torch.int32,
                                          device=device),
                    n_graphs=1, labels=labels)
    cfg = gin.GINConfig(d_in=8, d_hidden=32, n_layers=3, n_classes=8)
    params = gin.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0))
    opt_cfg = opt_mod.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=60,
                                  master_weights=False)
    opt_state = opt_mod.adamw_init(params, opt_cfg)
    step = train_loop.make_gnn_train_step(gin.forward, cfg, opt_cfg)
    for i in range(60):
        params, opt_state, metrics = step(params, opt_state, gb)
        if i % 10 == 0:
            print(f"step {i}: loss={float(metrics['loss']):.4f}")
    with torch.no_grad():
        logits = gin.forward(cfg, params, gb)
    acc = float((logits.argmax(-1) == gb.labels).float().mean())
    print(f"final nearest-anchor accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
