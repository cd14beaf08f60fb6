"""The paper's shortest paths as GNN positional features (anchor-distance
encoding), the port's copy of ``anchor_distance_features`` from the
reference's ``examples/gnn_sssp_features.py``.

K anchors' shortest-path trees, solved as one batched ``SolveSpec.tree``
(on ``backend="blocked"`` one ``edge_relax_batch`` launch a loop
iteration), give each node a K-dim distance profile; a GIN trained on it
learns the nearest anchor, which raw structure alone does not give.
"""
from __future__ import annotations

import numpy as np
import torch

from ...api import SolveSpec, Solver


def anchor_distance_features(g, k_anchors: int = 8, seed: int = 0, *,
                             config=None, layout=None, device=None):
    """``(feats, anchors)``: ``exp(-d)`` of each node's distance from each
    of ``k_anchors`` seeded anchors (0 where unreachable), ``[N, K]``
    float32 on the session's device, and the anchors (vertices of
    nonzero degree).  ``config``, ``layout`` and ``device`` open the
    :class:`~repro_torch.api.Solver` (default: ``segment_min`` on the
    card, as ``Solver.open``)."""
    deg = g.deg.cpu().numpy() if isinstance(g.deg, torch.Tensor) else g.deg
    rng = np.random.default_rng(seed)
    anchors = rng.choice(np.where(deg > 0)[0], k_anchors, replace=False)
    solver = Solver.open(g, config, layout=layout, device=device)
    d = solver.solve(SolveSpec.tree([int(a) for a in anchors])).dist
    feats = torch.where(torch.isfinite(d), torch.exp(-d), 0.0)
    return feats.T.contiguous().to(torch.float32), anchors
