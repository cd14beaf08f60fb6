"""Counts of work that depend on the algorithm only, never on the
program's tiles, schedules or launches, so that any design of a kernel
reads the same work.

``relax_bytes``: the least bytes a relaxation round has to move: each
relaxation attempt's destination id and weight read once (4 + 4 B), each
extended path's source distance read once (4 B), each improvement's
distance and parent written once (4 + 4 B).

``tree_edges``: Graph500's edge count of one traversal: the input edges
whose endpoints the tree reached, each undirected edge once, i.e. half
the degrees of the reached vertices summed.
"""
import torch

ATTEMPT_BYTES = 8
EXTENDED_BYTES = 4
UPDATE_BYTES = 8


def relax_bytes(n_relax: float, n_extended: float, n_updates: float) -> float:
    return (n_relax * ATTEMPT_BYTES + n_extended * EXTENDED_BYTES
            + n_updates * UPDATE_BYTES)


def reached_degree(dist: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """The degrees of the vertices a tree reached (``dist`` finite),
    summed: a 0-d int64 tensor on ``dist``'s device, read by nobody until
    the caller asks.  A tree reaches whole components, so the sum is
    twice the tree's edges."""
    return torch.where(torch.isfinite(dist), deg.to(torch.int64), 0).sum()


def tree_edges(dist: torch.Tensor, deg: torch.Tensor) -> int:
    """Edges of the tree whose distances are ``dist`` (``inf`` where
    unreached), from the degree of every vertex."""
    return int(reached_degree(dist, deg)) // 2
