"""Plain PyTorch flash attention: dense f32 softmax over the visible keys.

The plain version of ``csrc/flash_attn.cu`` and the port's counterpart of
the reference's ``kernels/flash_attn/ref.py``.  Scores, softmax and the
product with V are f32 whatever the input type; the output is cast back.
"""
from __future__ import annotations

import torch


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
    b, s, _, _, d = q.shape
    t = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(s, device=q.device).expand(b, s)
    if k_pos is None:
        k_pos = torch.arange(t, device=q.device).expand(b, t)
    scores = torch.einsum("bskhd,btkd->bskht", q.float(), k.float())
    scores = scores / (d ** 0.5)
    tp = k_pos[:, None, None, None, :]
    qp = q_pos[:, :, None, None, None]
    mask = (tp >= 0).expand(b, s, 1, 1, t)
    if causal:
        mask = mask & (tp <= qp)
    if window:
        mask = mask & (tp > qp - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bskht,btkd->bskhd", probs, v.float()).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q ``[B, H, S, D]``; k, v ``[B, Hkv, T, D]`` -> ``[B, H, S, D]``;
    query head ``h`` attends through KV head ``h // (H // Hkv)``."""
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    q5 = q.unflatten(1, (h_kv, h // h_kv)).permute(0, 3, 1, 2, 4)
    out = flash_attention_pos_ref(q5, k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window)
    return out.permute(0, 2, 3, 1, 4).reshape(b, h, s, d)
