"""Shared GNN shape set (all four GNN architectures), the port's copy of
``repro.configs.gnn_common``.

Per-shape graph dimensions; ``n_edges_directed`` counts the symmetrized
store.  ``triplet_cap`` bounds DimeNet triplets per edge (hub vertices on
power-law graphs would otherwise explode the quadratic gather).  On one
card the port trains ``full_graph_sm`` and ``molecule`` (``chip_smoke.py``
phase 4d) and ``minibatch_lg`` on ``data/sampler.py``'s batches (phase
4e-d, ``tools/gnn_phase.py``); ``ogb_products`` needs a sharded graph
(ROADMAP.md, queue 1 item 10)."""

SHAPES = {
    "full_graph_sm": {   # Cora-like full batch
        "kind": "train", "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
        "n_classes": 7, "triplet_cap": 8,
    },
    "minibatch_lg": {    # Reddit-like sampled training (fanout 15-10)
        "kind": "train_sampled", "n_nodes": 232965, "n_edges": 114615892,
        "d_feat": 602, "n_classes": 41, "batch_nodes": 1024,
        "fanout": (15, 10), "triplet_cap": 2, "dimenet_chunks": 4,
        # static padded subgraph sizes (seeds + 15 + 15*10 per seed)
        "sub_nodes": 181248, "sub_edges": 184320,
    },
    "ogb_products": {    # full-batch large
        "kind": "train", "n_nodes": 2449029, "n_edges": 61859140,
        "d_feat": 100, "n_classes": 47, "triplet_cap": 2, "dimenet_chunks": 64,
    },
    "molecule": {        # batched small graphs, graph-level regression
        "kind": "train_graphs", "n_nodes": 30, "n_edges": 64, "batch": 128,
        "d_feat": 16, "n_classes": 1, "triplet_cap": 8,
    },
}

SKIP_SHAPES = {}
