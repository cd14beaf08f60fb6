"""Plain PyTorch embedding bag: the plain versions of ``csrc/embedding_bag.cu``'s
two entries.

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

:func:`embedding_bag_masked_ref` is the masked entry's: the recsys layer's
raw ids under a bool mask, no weights.  Per lookup, in order: masked out,
nothing is added and nothing counts; masked in with an id in ``[-V, V)``,
``acc = acc + row(id)`` (ids in ``[-V, -1]`` wrap) and the count grows by
one; masked in with any other id, the bag is NaN.  The mean divides by the
count, or by 1e-9 when it is 0.  On a finite table this is bitwise what
the weighted entry gives for the layer's old ids and 0/1 weights: there a
masked-out lookup added ``row(0) * 0 = ±0`` to an accumulator that starts
at +0 and, under round-to-nearest, is never -0, so adding it changed no
bit.
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


def embedding_bag_masked_ref(table, ids, mask=None, *, mode: str = "sum"):
    """table ``[V, D]`` (f32 or bf16); ids ``[B, L]`` int; mask ``[B, L]``
    bool or None (all masked in) -> f32 ``[B, D]``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    b, l = ids.shape
    v = table.shape[0]
    rows = ids.long()
    rows = torch.where(rows < 0, rows + v, rows)
    ok = (rows >= 0) & (rows < v)
    live = torch.ones_like(ok) if mask is None else mask.bool()
    take = live & ok
    rows = torch.where(take, rows, 0)
    acc = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    cnt = torch.zeros((b, 1), dtype=torch.float32, device=table.device)
    for i in range(l):
        t = take[:, i:i + 1]
        acc = torch.where(t, acc + table[rows[:, i]].float(), acc)
        cnt = cnt + t
    if mode == "mean":
        acc = acc / cnt.clamp_min(1e-9)
    return acc.masked_fill((live & ~ok).any(1, keepdim=True), float("nan"))
