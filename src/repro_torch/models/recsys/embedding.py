"""The recsys embedding layer: bag pooling over an item table.

The port's counterpart of ``repro.models.recsys.embedding``.  Its two
functions keep the reference's results, including for ids outside
``[0, V)``, where the reference's ``jnp.take`` wraps ids in ``[-V, -1]``
to ``id + V`` and gives a NaN row for any other; :func:`take_rows`
reproduces that, and MIND uses it too.

* :func:`embedding_bag_batched` (dense bags ``[B, L]``) is the layer's
  hot loop, and on the card every call is one launch of the
  ``embedding_bag`` kernel's masked entry, which reads the raw ids and
  mask (on the CPU, its plain version).
* :func:`embedding_bag` (ragged bags) stays on plain torch: the reference
  computes it with ``segment_sum``, outside any kernel.
"""
from __future__ import annotations

import torch

from ...kernels.embedding_bag import ops


def _wrap(ids, n_rows: int):
    """``jnp.take``'s index rule: ``idx = ids + V`` where ``ids < 0``
    (int64), and ``ok`` where ``0 <= idx < V``."""
    idx = ids.long()
    idx = torch.where(idx < 0, idx + n_rows, idx)
    return idx, (idx >= 0) & (idx < n_rows)


def take_rows(table, ids):
    """``jnp.take(table, ids, axis=0)``: rows ``[*ids.shape, D]`` in the
    table's dtype; ids in ``[-V, -1]`` wrap to ``id + V``, and an id
    outside ``[-V, V)`` gives a NaN row."""
    idx, ok = _wrap(ids, table.shape[0])
    rows = table[torch.where(ok, idx, 0)]
    return rows.masked_fill(~ok[..., None], float("nan"))


def bag_inputs(n_rows: int, ids, mask=None):
    """The weighted entry's ids and weights for dense bags ``ids``
    ``[B, L]`` under ``mask``, by ``jnp.take``'s index rule (:func:`_wrap`).
    Weights are 1.0 where masked in and ok, NaN where masked in and not ok
    (the reference's NaN row), 0.0 where masked out; ids are ``idx`` where
    masked in and ok, else 0.  The layer does not call the weighted entry
    on these (a masked-out lookup would add ``row(0) * 0``, NaN when row 0
    is not finite); they are the weighted entry's form of the layer's
    inputs, and on a finite table ``embedding_bag(table,
    *bag_inputs(...))`` equals the masked entry bit for bit."""
    idx, ok = _wrap(ids, n_rows)
    keep = ok if mask is None else ok & mask
    live = torch.ones_like(ok) if mask is None else mask
    w = torch.where(keep, 1.0, torch.where(live, float("nan"), 0.0))
    return (torch.where(keep, idx, 0).to(torch.int32).contiguous(),
            w.to(torch.float32).contiguous())


def embedding_bag_batched(table, ids, mask=None, mode: str = "sum"):
    """Dense bags: ids ``[B, L]`` -> ``[B, D]`` in the table's dtype
    (``mask`` ``[B, L]`` bool marks the real lookups; None means all).

    One call of ``ops.embedding_bag_masked`` (the kernel's masked entry on
    the card, its plain version on the CPU) on the raw ids and mask.  The
    result is the reference's: a masked-out lookup adds nothing, whatever
    its row holds (the reference's ``where(mask, row, 0)``); a masked-in
    id in ``[-V, -1]`` wraps and one outside ``[-V, V)`` makes its bag NaN
    (``jnp.take``'s NaN row); for ``mode="mean"`` the divisor is the mask
    count, or 1e-9 where the reference takes ``max(count, 1)``: a bag with
    none is 0 either way.  The sum runs in f32 in lookup order, so it may
    differ from the reference's ``sum(-2)`` in the last bits; a bf16
    table's result is rounded back to bf16, as the reference returns it.
    Ids of another integer dtype are clamped into int32 first, which
    keeps an id outside ``[-V, V)`` outside for any table of fewer than
    2^31 rows."""
    if ids.dtype != torch.int32:
        ids = ids.clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32)
    out = ops.embedding_bag_masked(table, ids.contiguous(),
                                   None if mask is None else mask.contiguous(),
                                   mode=mode)
    return out.to(table.dtype)


def embedding_bag(table, ids, bag_ids, n_bags: int, weights=None,
                  mode: str = "sum"):
    """Ragged bags: ids ``[N]``, bag_ids ``[N]`` (sorted or not) ->
    ``[n_bags, D]`` in the table's dtype; ``weights`` ``[N]`` optional
    per-lookup scale.  Plain torch, as the reference's ``segment_sum``:
    rows by :func:`take_rows`, then ``index_add_``; lookups whose bag id is
    outside ``[0, n_bags)`` are dropped, as ``segment_sum`` drops them.
    ``mode="mean"`` divides by ``max(count or weight sum, 1e-9)``."""
    vecs = take_rows(table, ids)
    if weights is not None:
        vecs = vecs * weights[:, None].to(vecs.dtype)
    bag_ids = bag_ids.long()
    keep = (bag_ids >= 0) & (bag_ids < n_bags)
    out = torch.zeros((n_bags, table.shape[1]), dtype=vecs.dtype,
                      device=table.device)
    out.index_add_(0, bag_ids[keep], vecs[keep])
    if mode == "mean":
        each = (torch.ones(ids.shape, dtype=vecs.dtype, device=table.device)
                if weights is None else weights.to(vecs.dtype))
        cnt = torch.zeros((n_bags,), dtype=vecs.dtype, device=table.device)
        cnt.index_add_(0, bag_ids[keep], each[keep])
        out = out / cnt[:, None].clamp_min(1e-9)
    return out
