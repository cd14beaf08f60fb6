"""Plain PyTorch flash attention: dense f32 softmax over the visible keys.

The plain version of ``csrc/flash_attn.cu`` and the port's counterpart of
the reference's ``kernels/flash_attn/ref.py``.  Scores, softmax and the
product with V are f32 whatever the input type; the output is cast back.
:func:`flash_attention_split_ref` states the kernel's split-KV decode
("split") as plain torch, chunk partials and their merge, for the tests;
nothing on the model path calls it.
"""
from __future__ import annotations

import torch


def _scores(q, k, q_pos, k_pos, causal, window):
    """f32 scores ``[B, S, KV, HG, T]`` scaled by 1/sqrt(D), the
    visibility mask (broadcastable to them) and the query positions as
    int64 (``None`` = ``0..S-1``; k_pos ``None`` = ``0..T-1``)."""
    b, s, _, _, d = q.shape
    t = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(s, device=q.device).expand(b, s)
    if k_pos is None:
        k_pos = torch.arange(t, device=q.device).expand(b, t)
    q_pos, k_pos = q_pos.long(), k_pos.long()
    scores = torch.einsum("bskhd,btkd->bskht", q.float(), k.float())
    scores = scores / (d ** 0.5)
    tp = k_pos[:, None, None, None, :]
    qp = q_pos[:, :, None, None, None]
    mask = (tp >= 0).expand(b, s, 1, 1, t)
    if causal:
        mask = mask & (tp <= qp)
    if window:
        mask = mask & (tp > qp - window)
    return scores, mask, q_pos


def flash_attention_pos_ref(q, k, v, q_pos=None, k_pos=None, *,
                            causal: bool = True, window: int = 0):
    """Attention with per-query and per-key positions.

    q ``[B, S, KV, HG, D]`` (``HG`` query heads per KV head), k/v
    ``[B, T, KV, D]``, q_pos ``[B, S]`` and k_pos ``[B, T]`` int (``None``
    = positions ``0..S-1``, ``0..T-1``).  A key is visible to a query iff
    its position is >= 0, and with ``causal`` also <= the query's, and
    with ``window`` also > the query's minus ``window``; a query with no
    visible key gives 0.  Returns ``[B, S, KV, HG, D]`` in q's dtype.
    """
    scores, mask, _ = _scores(q, k, q_pos, k_pos, causal, window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bskht,btkd->bskhd", probs, v.float()).to(q.dtype)


def flash_attention_split_ref(q, k, v, q_pos=None, k_pos=None, *,
                              causal: bool = True, window: int = 0,
                              n_split: int = 1):
    """:func:`flash_attention_pos_ref`'s function computed as the
    ``"split"`` kernel does: each row ``b`` cuts its key range ``[lo,
    hi)`` (with ``k_pos=None``: causal up to the last query's position,
    window from the first's minus ``window`` plus 1; else all ``T`` keys)
    into ``n_split`` chunks of ``ceil((hi - lo) / n_split)`` keys; each
    chunk gives a partial ``(m, l, acc)`` (``m = -inf``, ``l = 0``,
    ``acc = 0`` where it sees no key), and the partials merge in chunk
    order: ``M = max m``, ``w = exp(m - M)``, ``out = sum w acc /
    max(sum w l, 1e-30)``.  f32 inside; q's dtype out."""
    b, t = q.shape[0], k.shape[1]
    scores, mask, qp = _scores(q, k, q_pos, k_pos, causal, window)
    keys = torch.arange(t, device=q.device).expand(b, t)
    lo = torch.zeros(b, dtype=torch.long, device=q.device)
    hi = torch.full((b,), t, dtype=torch.long, device=q.device)
    if k_pos is None:
        if causal:
            hi = torch.minimum(hi, qp.max(1).values + 1)
        if window:
            lo = torch.maximum(lo, qp.min(1).values - window + 1)
    hi = torch.maximum(lo, hi)
    size = ((hi - lo + n_split - 1) // n_split).clamp(min=1)
    inside = (keys >= lo[:, None]) & (keys < hi[:, None])
    chunk = torch.where(inside, (keys - lo[:, None]) // size[:, None], -1)
    parts = []
    for c in range(n_split):
        mc = mask & (chunk == c)[:, None, None, None, :]
        sc = scores.masked_fill(~mc, float("-inf"))
        m = sc.amax(-1)                                   # [b, s, kv, hg]
        e = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        parts.append((m, e.sum(-1), torch.einsum("bskht,btkd->bskhd", e,
                                                 v.float())))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - big), 0.0)
        den = den + w * l
        num = num + w[..., None] * acc
    return (num / den.clamp(min=1e-30)[..., None]).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q ``[B, H, S, D]``; k, v ``[B, Hkv, T, D]`` -> ``[B, H, S, D]``;
    query head ``h`` attends through KV head ``h // (H // Hkv)``."""
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    q5 = q.unflatten(1, (h_kv, h // h_kv)).permute(0, 3, 1, 2, 4)
    out = flash_attention_pos_ref(q5, k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window)
    return out.permute(0, 2, 3, 1, 4).reshape(b, h, s, d)
