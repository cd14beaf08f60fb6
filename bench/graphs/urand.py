"""GAP's Urand graphs on the card, from a seed: ``2^scale`` vertices and
``degree * 2^scale`` undirected edges with endpoints uniform over the
vertices (Erdős–Rényi with a fixed edge count); self loops are drawn
again, duplicate edges are kept.  The weighted structure is the
configuration's; each run relabels its vertices."""
import torch

from bench.graphs import (WEIGHTS, EdgeList, structure_generator,
                          without_self_loops)


def generate(cfg: dict, gen: torch.Generator, device) -> EdgeList:
    """The configuration's graph, from its keys ``scale``, ``degree``,
    ``weights`` and ``structure_seed``: the endpoint pairs and the
    weights come from ``structure_seed``, a label permutation from the
    run's ``gen``."""
    g = cfg
    n = 1 << int(g["scale"])
    m = int(g["degree"]) * n
    fixed = structure_generator(g, device)

    def draw(k):
        uv = torch.randint(0, n, (2, k), generator=fixed, device=device)
        return uv[0], uv[1]
    u, v = without_self_loops(m, draw)
    w = WEIGHTS[g["weights"]](m, fixed, device)
    perm = torch.randperm(n, generator=gen, device=device)
    return EdgeList(n=n, eu=perm[u], ev=perm[v], ew=w)
