"""MIND: Multi-Interest Network with Dynamic routing (arXiv:1904.08030),
its serving path and its training loss.

The port's counterpart of ``repro.models.recsys.mind``: an item table
``[V, D]`` gives behaviour embeddings ``[B, L, D]``; B2I dynamic routing
(``capsule_iters`` rounds) turns them into interests ``[B, K, D]``, which
serving scores against candidate items by their best interest.  Rows are
gathered with :func:`~repro_torch.models.recsys.embedding.take_rows`
(``jnp.take``'s semantics) and the products are ``torch.einsum``, as the
reference leaves both to XLA.  Training (:func:`train_loss`) is a
sampled softmax with in-batch negatives over the label-aware attention
of the interests to the target item.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..layers import dense_init, embed_init
from .embedding import take_rows


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 10_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 2.0          # label-aware attention sharpness
    dtype: torch.dtype = torch.float32


def init_params(cfg: MINDConfig, gen: torch.Generator) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on its device: the item table ``normal * 0.02`` and the shared
    bilinear routing map ``s_map`` by ``dense_init``."""
    return {
        "item_embed": embed_init(gen, cfg.n_items, cfg.embed_dim, cfg.dtype),
        "s_map": dense_init(gen, cfg.embed_dim, cfg.embed_dim, cfg.dtype),
    }


def _on(params, x):
    """``x`` (a tensor or numpy array) on the parameters' device."""
    return torch.as_tensor(x, device=params["item_embed"].device)


def squash(s):
    n2 = torch.sum(s * s, -1, keepdim=True)
    return (n2 / (1 + n2)) * s / torch.sqrt(n2 + 1e-9)


def multi_interest(cfg: MINDConfig, params, hist_ids, hist_mask):
    """B2I dynamic routing: hist_ids ``[B, L]`` under hist_mask ``[B, L]``
    -> interests ``[B, K, D]``.  The routing logits start at the fixed
    ``sin(l * (1 + k))`` of the reference (torch's ``sin`` may differ from
    XLA's by an ulp)."""
    hist_ids, hist_mask = _on(params, hist_ids), _on(params, hist_mask)
    b, l = hist_ids.shape
    k = cfg.n_interests
    live = hist_mask[..., None]
    e = take_rows(params["item_embed"], hist_ids)               # [B, L, D]
    e = torch.where(live, e, 0.0)
    eh = torch.einsum("bld,de->ble", e, params["s_map"])        # behaviour caps
    dev = e.device
    init_b = torch.sin(
        torch.arange(l, dtype=torch.float32, device=dev)[:, None] *
        (1.0 + torch.arange(k, dtype=torch.float32, device=dev)[None, :]))
    blog = init_b.expand(b, l, k).float()
    interests = None
    for it in range(cfg.capsule_iters):
        w = torch.softmax(blog, dim=-1)                         # over K
        w = torch.where(live, w, 0.0)
        s = torch.einsum("blk,bld->bkd", w, eh)
        interests = squash(s)
        if it < cfg.capsule_iters - 1:
            blog = blog + torch.einsum("bkd,bld->blk", interests, eh)
    return interests.to(cfg.dtype)                              # [B, K, D]


def label_aware_attention(cfg: MINDConfig, interests, target_e):
    """The paper's ``v_u = sum_k softmax_k(max(u_k . e_t, 1e-9) ** p)
    u_k``: interests ``[B, K, D]``, target embeddings ``[B, D]`` ->
    ``[B, D]``; the logits and softmax in f32."""
    logits = torch.einsum("bkd,bd->bk", interests.float(), target_e.float())
    w = torch.softmax(torch.pow(logits.clamp_min(1e-9), cfg.pow_p), dim=-1)
    return torch.einsum("bk,bkd->bd", w.to(interests.dtype), interests)


def train_loss(cfg: MINDConfig, params, batch):
    """Sampled softmax with in-batch negatives: each user's attended
    interest against every target of the batch, its own as the label;
    ``batch`` ``{"hist": [B, L], "hist_mask": [B, L], "target": [B]}``
    (tensors or numpy arrays).  Returns ``(loss, {"loss": loss})``."""
    interests = multi_interest(cfg, params, batch["hist"],
                               batch["hist_mask"])
    tgt_e = take_rows(params["item_embed"], _on(params, batch["target"]))
    user = label_aware_attention(cfg, interests, tgt_e)        # [B, D]
    logits = torch.einsum("bd,cd->bc", user.float(),
                          tgt_e.float()) / math.sqrt(cfg.embed_dim)
    lse = torch.logsumexp(logits, dim=-1)
    loss = (lse - torch.diagonal(logits)).mean()
    return loss, {"loss": loss}


def serve_interests(cfg: MINDConfig, params, batch):
    """Online inference: user interests ``[B, K, D]`` from a batch's
    ``"hist"`` and ``"hist_mask"`` (tensors or numpy arrays, as
    :class:`~repro_torch.data.synthetic.RecsysStream` gives them), on the
    parameters' device."""
    return multi_interest(cfg, params, batch["hist"], batch["hist_mask"])


def retrieval_scores(cfg: MINDConfig, params, interests, cand_ids):
    """Score one user's interests ``[K, D]`` against candidate ids ``[C]``:
    each candidate's best interest, ``max_k <u_k, e_c>``, f32 ``[C]``
    (one batched product).  A candidate id outside ``[-V, V)`` scores
    NaN, as in the reference."""
    cand = take_rows(params["item_embed"], _on(params, cand_ids))  # [C, D]
    s = torch.einsum("kd,cd->kc", _on(params, interests).float(),
                     cand.float())
    return torch.amax(s, dim=0)
