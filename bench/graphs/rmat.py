"""Graph500 Kronecker (R-MAT) graphs on the card, from a seed.

``2^scale`` vertices and ``edge_factor * 2^scale`` undirected edges.
Each endpoint pair picks one quadrant per bit with probabilities A, B, C
and D = 1 - A - B - C; self loops are drawn again; the vertex labels are
permuted, as Graph500 and GAP's Kron do.  Duplicate edges are kept.
The structure is the configuration's (one graph, as GAP runs all its
trials on one generated graph); each run relabels its vertices.
"""
import torch

from bench.graphs import (WEIGHTS, EdgeList, structure_generator,
                          without_self_loops)


def _pairs(k: int, scale: int, a: float, b: float, c: float, gen, device):
    u = torch.zeros(k, dtype=torch.int64, device=device)
    v = torch.zeros(k, dtype=torch.int64, device=device)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for bit in range(scale):
        r = torch.rand(2, k, generator=gen, device=device)
        u_bit = r[0] > ab
        v_bit = torch.where(u_bit, r[1] > c_norm, r[1] > a_norm)
        u |= u_bit.to(torch.int64) << bit
        v |= v_bit.to(torch.int64) << bit
    return u, v


def generate(cfg: dict, gen: torch.Generator, device) -> EdgeList:
    """The configuration's graph, from its keys ``scale``,
    ``edge_factor``, ``a``, ``b``, ``c``, ``weights`` and
    ``structure_seed``: the endpoint pairs and the weights come from
    ``structure_seed``, the label permutation from the run's ``gen``."""
    g = cfg
    scale, n = int(g["scale"]), 1 << int(g["scale"])
    m = int(g["edge_factor"]) * n
    fixed = structure_generator(g, device)
    u, v = without_self_loops(m, lambda k: _pairs(
        k, scale, float(g["a"]), float(g["b"]), float(g["c"]), fixed,
        device))
    w = WEIGHTS[g["weights"]](m, fixed, device)
    perm = torch.randperm(n, generator=gen, device=device)
    return EdgeList(n=n, eu=perm[u], ev=perm[v], ew=w)
