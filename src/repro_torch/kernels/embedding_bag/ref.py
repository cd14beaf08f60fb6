"""Plain PyTorch embedding bag: the plain version of ``csrc/embedding_bag.cu``.

It computes what the kernel computes, in the kernel's order, so that the
two agree bit for bit on the card: for each bag ``b``, starting from 0,
``acc = acc + row(ids[b, l]) * w[b, l]`` for ``l = 0, 1, ..., L-1`` (a
multiply rounded, then an add rounded), in f32 whatever the table's type.
For ``mode="mean"`` the bag's weight sum, also taken in lookup order, is
clamped at 1e-9 and divides the sum once at the end.  Without weights,
every weight is 1.0, so the mean divides by L.

Ids follow the reference's Pallas kernel as it runs in interpret mode: an
id in ``[-V, -1]`` wraps to ``id + V``; any other id outside ``[0, V)`` is
clamped to ``[0, V-1]``.
"""
from __future__ import annotations

import torch

MODES = ("sum", "mean")


def embedding_bag_ref(table, ids, weights=None, *, mode: str = "sum"):
    """table ``[V, D]`` (f32 or bf16); ids ``[B, L]`` int; weights
    ``[B, L]`` f32 or None -> f32 ``[B, D]``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    b, l = ids.shape
    v = table.shape[0]
    rows = ids.long()
    rows = torch.where(rows < 0, rows + v, rows).clamp(0, v - 1)
    acc = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    wsum = torch.zeros((b, 1), dtype=torch.float32, device=table.device)
    for i in range(l):
        w = (torch.ones((b, 1), dtype=torch.float32, device=table.device)
             if weights is None else weights[:, i:i + 1].float())
        acc = acc + table[rows[:, i]].float() * w
        wsum = wsum + w
    if mode == "mean":
        acc = acc / wsum.clamp_min(1e-9)
    return acc
