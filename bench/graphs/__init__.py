"""Graph generators and the CSR preprocessing, in torch on the card.

Frozen copies, independent of the port: ``rmat.py`` (Graph500 Kronecker)
and ``urand.py`` (Erdős–Rényi) draw an undirected edge list from a
``torch.Generator``; ``csr.py`` turns it into the arrays of the port's
``DeviceGraph`` as ``repro_torch.core.graph.build_csr`` would.
"""
from typing import NamedTuple

import torch


class EdgeList(NamedTuple):
    """An undirected edge list: edge ``i`` joins ``eu[i]`` and ``ev[i]``
    with weight ``ew[i]``."""
    n: int
    eu: torch.Tensor      # [m] int64
    ev: torch.Tensor      # [m] int64
    ew: torch.Tensor      # [m] float32


def without_self_loops(m: int, draw) -> tuple:
    """Endpoint pairs from ``draw(k)`` until exactly ``m`` pairs that are
    not self loops have accumulated (one host read a batch)."""
    us, vs, have = [], [], 0
    while have < m:
        u, v = draw(m - have)
        keep = u != v
        u, v = u[keep], v[keep]
        us.append(u)
        vs.append(v)
        have += int(u.shape[0])
    return torch.cat(us)[:m], torch.cat(vs)[:m]


def structure_generator(cfg: dict, device) -> torch.Generator:
    """The generator of a configuration's weighted graph structure: seeded
    with its ``structure_seed``, the same in every run."""
    return torch.Generator(device=device).manual_seed(
        int(cfg["structure_seed"]))


def uniform_weights(m: int, gen: torch.Generator, device) -> torch.Tensor:
    """Weights uniform in (0, 1], float32, as the Graph500 SSSP kernel
    draws them (one minus a draw from [0, 1))."""
    return 1.0 - torch.rand(m, generator=gen, device=device,
                            dtype=torch.float32)


WEIGHTS = {"uniform_0_1": uniform_weights}
