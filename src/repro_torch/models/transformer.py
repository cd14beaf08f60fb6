"""Decoder-only transformer LM (dense and MoE) in PyTorch: forward,
the training loss, prefill and the decode step of the serving path.

Port of ``repro.models.transformer`` on one card: GQA attention with an
explicit ``head_dim``, RoPE applied before the cache (absolute
positions, so a ring buffer serves sliding-window decode), optional
qk-norm, SwiGLU or GELU MLP, tied or separate LM head, and MoE layers
(:func:`moe_block`: shared plus top-k routed experts, capacity-based
sort dispatch, the Switch aux loss) in plain torch ops, as the
reference leaves them to XLA.  The reference's ``lax.scan`` over stacked
layers is a Python loop over the same stacked parameters; its per-layer
``jax.checkpoint`` is ``torch.utils.checkpoint`` under ``cfg.remat``.
Not here: the reference's ``_constrain``/``act_spec`` (sharding
constraints; ``cfg.seq_shard`` is kept and, as the reference's
constraint outside a mesh, does nothing on one card).

Attention runs one of two implementations, named by ``attn``:

* ``"flash"``: ``kernels/flash_attn``'s :func:`flash_attention_pos`, the
  hand-written CUDA kernel on the card (its plain f32 version on the
  CPU), reading the cache in place.  It has no backward: on the card it
  refuses inputs that require grad under grad mode;
* ``"plain"``: the reference's own attention translated op for op
  (:func:`_sdpa_dense`, :func:`_sdpa_blockwise` above ``s * t > 2**21``,
  and the decode step's :func:`_sdpa_decode`), with the reference's bf16
  roundings of scores and probabilities.  :func:`loss_fn` (training)
  always runs it, as the reference trains through XLA's attention.

``attn=None`` takes ``"flash"`` on a CUDA device and ``"plain"`` on the
CPU; nothing switches from one to the other on its own.

The KV cache is ``{"k", "v": [L, B, S_cache, KV, HD], "pos": [B]}``;
:func:`decode_step` writes the new keys and values into it in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..core.sssp import resolve_device
from ..kernels.flash_attn.ops import flash_attention_pos
from .layers import apply_rope, dense_init, embed_init, gelu_mlp, rms_norm, \
    softmax_cross_entropy, swiglu

ATTN = ("flash", "plain")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 => d_model // n_heads
    mlp: str = "swiglu"               # "swiglu" | "gelu"
    qk_norm: bool = False
    rope_theta: float = 1e4
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0                 # shared (always-on) experts
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # attention
    attn_window: int = 0              # 0 => full causal
    tied_embed: bool = False          # lm_head = embed.T (qwen3, phi4)
    # numerics
    dtype: Any = torch.bfloat16
    # distribution
    seq_shard: bool = False           # Megatron-SP residual stream: a
    #                                   sharding hint, nothing on one card
    remat: bool = True                # recompute each layer in backward

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        d, hd, h, kv = self.d_model, self.hd, self.n_heads, self.n_kv
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.moe:
            e_ff = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
            mlp = (self.n_experts + self.n_shared) * e_ff + d * self.n_experts
        else:
            mlp = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        n_embed = (1 if self.tied_embed else 2) * self.vocab * d
        return (self.n_layers * per_layer + n_embed + d +
                (2 * self.n_layers * hd if self.qk_norm else 0))


def resolve_attn(attn, device) -> str:
    """The attention implementation: ``attn`` if given, else ``"flash"``
    on a CUDA device and ``"plain"`` on the CPU."""
    if attn is None:
        attn = "flash" if torch.device(device).type == "cuda" else "plain"
    if attn not in ATTN:
        raise ValueError(f"attn must be one of {ATTN}, got {attn!r}")
    return attn


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: LMConfig, gen: torch.Generator) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on its device: per-layer tensors stacked on a leading
    ``n_layers`` axis (experts on a second one), norms at one, the MoE
    router in float32 whatever ``cfg.dtype`` is.  Every stack is drawn
    one layer at a time into its ``cfg.dtype`` tensor
    (:func:`~repro_torch.models.layers.dense_init`)."""
    d, hd, h, kv, L, dt = (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv,
                           cfg.n_layers, cfg.dtype)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=gen.device)
    out_scale = lambda fan_in: 1.0 / (fan_in ** 0.5 * (2 * L) ** 0.5)
    stack = dict(lead=(L,))
    layer = {
        "ln1": ones(L, d),
        "ln2": ones(L, d),
        "wq": dense_init(gen, d, h * hd, dt, **stack),
        "wk": dense_init(gen, d, kv * hd, dt, **stack),
        "wv": dense_init(gen, d, kv * hd, dt, **stack),
        "wo": dense_init(gen, h * hd, d, dt, out_scale(h * hd), **stack),
    }
    if cfg.qk_norm:
        layer["q_norm"] = ones(L, hd)
        layer["k_norm"] = ones(L, hd)
    f = cfg.d_ff
    if cfg.moe:
        e = cfg.n_experts
        experts = dict(lead=(L, e))
        layer["router"] = dense_init(gen, d, e, torch.float32, **stack)
        layer["e_up"] = dense_init(gen, d, f, dt, **experts)
        layer["e_down"] = dense_init(gen, f, d, dt, out_scale(f), **experts)
        if cfg.mlp == "swiglu":
            layer["e_gate"] = dense_init(gen, d, f, dt, **experts)
        if cfg.n_shared:
            fs = f * cfg.n_shared
            layer["s_up"] = dense_init(gen, d, fs, dt, **stack)
            layer["s_down"] = dense_init(gen, fs, d, dt, out_scale(fs),
                                         **stack)
            if cfg.mlp == "swiglu":
                layer["s_gate"] = dense_init(gen, d, fs, dt, **stack)
    else:
        layer["w_up"] = dense_init(gen, d, f, dt, **stack)
        layer["w_down"] = dense_init(gen, f, d, dt, out_scale(f), **stack)
        if cfg.mlp == "swiglu":
            layer["w_gate"] = dense_init(gen, d, f, dt, **stack)
    out = {"embed": embed_init(gen, cfg.vocab, d, dt), "layers": layer,
           "ln_f": ones(d)}
    if not cfg.tied_embed:
        out["lm_head"] = dense_init(gen, d, cfg.vocab, dt)
    return out


def _layer(params: dict, i: int) -> dict:
    return {k: w[i] for k, w in params["layers"].items()}


def _logits(cfg: LMConfig, params, x):
    if cfg.tied_embed:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# attention / mlp / moe blocks
# ---------------------------------------------------------------------------

def _sdpa_dense(cfg: LMConfig, q, k_all, v_all, positions, t_pos, causal):
    """Materialized-scores attention (small S only / smoke tests)."""
    b, s = q.shape[:2]
    t = k_all.shape[1]
    scores = torch.einsum("bskhd,btkd->bskht", q, k_all).float()
    scores = scores / (cfg.hd ** 0.5)
    qp = positions[:, :, None, None, None]
    tp = t_pos[:, None, None, None, :]
    mask = torch.ones((b, s, 1, 1, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (tp <= qp)
    if cfg.attn_window:
        mask = mask & (tp > qp - cfg.attn_window)
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    # rows with no valid key (padding) produce NaN; zero them
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bskht,btkd->bskhd", probs.to(q.dtype), v_all)


def _sdpa_blockwise(cfg: LMConfig, q, k_all, v_all, positions, t_pos, causal,
                    block_q: int = 512, block_k: int = 1024):
    """Online-softmax blockwise attention (the reference's XLA 'flash'
    path), one (block_q x block_k) score tile at a time."""
    b, s, kv, hg, hd = q.shape
    t = k_all.shape[1]
    bq, bk = min(block_q, s), min(block_k, t)
    nq, nk = -(-s // bq), -(-t // bk)
    pad_q, pad_k = nq * bq - s, nk * bk - t
    qp = F.pad(positions, (0, pad_q))
    tp = F.pad(t_pos, (0, pad_k), value=-1)
    qb = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
    kb = F.pad(k_all, (0, 0, 0, 0, 0, pad_k))
    vb = F.pad(v_all, (0, 0, 0, 0, 0, pad_k))
    scale = 1.0 / (hd ** 0.5)
    outs = []
    for i in range(nq):
        qi, qpi = qb[:, i * bq:(i + 1) * bq], qp[:, i * bq:(i + 1) * bq]
        qpi = qpi[:, :, None, None, None]
        m = torch.full((b, bq, kv, hg), float("-inf"), device=q.device)
        l = torch.zeros((b, bq, kv, hg), device=q.device)
        acc = torch.zeros((b, bq, kv, hg, hd), device=q.device)
        for j in range(nk):
            ki, vi = kb[:, j * bk:(j + 1) * bk], vb[:, j * bk:(j + 1) * bk]
            tpi = tp[:, None, None, None, j * bk:(j + 1) * bk]
            sc = torch.einsum("bskhd,btkd->bskht", qi, ki).float() * scale
            msk = tpi >= 0
            if causal:
                msk = msk & (tpi <= qpi)
            if cfg.attn_window:
                msk = msk & (tpi > qpi - cfg.attn_window)
            sc = sc.masked_fill(~msk, float("-inf"))
            m2 = torch.maximum(m, sc.amax(-1))
            m2s = torch.where(torch.isfinite(m2), m2, 0.0)
            p = torch.where(msk, torch.exp(sc - m2s[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m2s), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bskht,btkd->bskhd", p.to(qi.dtype), vi).float()
            m = m2
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.cat(outs, dim=1)[:, :s].to(q.dtype)


def _sdpa_decode(cfg: LMConfig, q, kc, vc, pos, kv_positions):
    """The reference decode step's inline attention: one query per slot
    at ``pos`` over the whole cache, keys at ``kv_positions``."""
    scores = torch.einsum("bskhd,btkd->bskht", q, kc).float()
    scores = scores / (cfg.hd ** 0.5)
    tp = kv_positions[:, None, None, None, :]
    qp = pos[:, None, None, None, None]
    mask = (tp <= qp) & (tp >= 0)
    if cfg.attn_window:
        mask = mask & (tp > qp - cfg.attn_window)
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bskht,btkd->bskhd", probs.to(q.dtype), vc)


def attention(cfg: LMConfig, lp: dict, x, *, attn="plain"):
    """Causal self-attention block over the positions ``0..S-1`` of every
    row (the reference's ``attention`` as prefill and forward call it;
    the decode step attends over its cache itself).  x: ``[B, S, D]``.
    Returns ``(out [B, S, D], k, v)`` with the new keys (after RoPE) and
    values ``[B, S, KV, HD]``."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = (x @ lp["wq"]).reshape(b, s, kv, h // kv, hd)
    k = (x @ lp["wk"]).reshape(b, s, kv, hd)
    v = (x @ lp["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(
        b, s)
    q = apply_rope(q.reshape(b, s, h, hd), positions,
                   cfg.rope_theta).reshape(b, s, kv, h // kv, hd)
    k = apply_rope(k, positions, cfg.rope_theta)
    if attn == "flash":     # positions 0..S-1: a causal block stops early
        out = flash_attention_pos(q, k, v, causal=True,
                                  window=cfg.attn_window)
    elif s * s > (1 << 21):
        out = _sdpa_blockwise(cfg, q, k, v, positions, positions, True)
    else:
        out = _sdpa_dense(cfg, q, k, v, positions, positions, True)
    return out.reshape(b, s, h * hd) @ lp["wo"], k, v


class Route(NamedTuple):
    """A MoE layer's routing of ``t`` tokens (:func:`moe_route`): the f32
    router ``probs [T, E]``, each token's top-k ``gate`` (renormalised)
    and expert ``idx [T, k]``, the aux loss, the per-expert capacity
    ``cap``, and the ``T * k`` token-choices sorted stably by expert:
    ``order`` (their flat ``t * k + j`` positions), expert ``se``, token
    ``st``, gate ``sg``, ``rank`` within the expert, and ``keep`` (rank
    below ``cap``; the rest are dropped)."""
    probs: Any
    gate: Any
    idx: Any
    aux: Any
    cap: int
    order: Any
    se: Any
    st: Any
    sg: Any
    rank: Any
    keep: Any


def moe_route(cfg: LMConfig, lp: dict, xt) -> Route:
    """Route tokens ``xt [T, D]``: f32 router logits and softmax, top-k
    in ``jax.lax.top_k``'s order (probability descending, the lower
    expert first on a tie: a stable descending sort), renormalised
    gates, the Switch load-balance aux loss ``coef * E * sum_e f_e
    p_e``, and the stable sort of the token-choices by expert with each
    one's rank from ``searchsorted``.  ``cap = max(int(T * k / E *
    capacity_factor), 8)`` in Python floats, as the reference."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ lp["router"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top.values[:, :k], top.indices[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(0)
    ce = F.one_hot(idx, e).sum(1).float().mean(0)
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce)
    cap = max(int(t * k / e * cfg.capacity_factor), 8)
    flat_e = idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    st = torch.div(order, k, rounding_mode="floor")
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(t * k, device=xt.device) - first
    return Route(probs, gate, idx, aux, cap, order, se, st,
                 gate.reshape(-1)[order], rank, rank < cap)


def moe_combine(y_tok, order, t: int, k: int):
    """Each token's sum of its ``k`` rows of ``y_tok`` (``[T * k, D]`` in
    the sorted order ``order``), added from zero in ascending expert
    order, as the reference's ``segment_sum`` over the sorted choices
    adds them; a gather and ``k`` adds, so the bits do not depend on
    the order threads run in (``index_add_`` on the card adds with
    atomics)."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    rows = y_tok[inv.reshape(t, k).sort(dim=1).values]       # [T, k, D]
    y = torch.zeros_like(rows[:, 0])
    for j in range(k):
        y = y + rows[:, j]
    return y


def moe_block(cfg: LMConfig, lp: dict, x):
    """Top-k routed experts with capacity-based sort dispatch, plus the
    shared experts.  x: ``[B, S, D]``, flattened to tokens.  Returns
    ``(y [B, S, D], aux)``.

    Every kept (expert, rank) slot of the ``[E, cap, D]`` dispatch buffer
    is written once (dropped choices go to a spare row that is thrown
    away); the experts run as batched matmuls; :func:`moe_combine` adds
    each token's gated rows.  Padding tokens route like any other and
    use up capacity, as in the reference."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(b * s, d)
    t = b * s
    r = moe_route(cfg, lp, xt)
    slot = torch.where(r.keep, r.se * r.cap + r.rank, e * r.cap)
    buf = torch.zeros((e * r.cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xt[r.st])[:-1].reshape(e, r.cap, d)
    if cfg.mlp == "swiglu":
        hidden = F.silu(torch.bmm(buf, lp["e_gate"])) * torch.bmm(
            buf, lp["e_up"])
    else:
        hidden = F.gelu(torch.bmm(buf, lp["e_up"]), approximate="tanh")
    out_buf = torch.bmm(hidden, lp["e_down"])
    y_tok = out_buf[r.se, r.rank.clamp(max=r.cap - 1)]
    y_tok = torch.where(r.keep[:, None], y_tok, 0.0) * r.sg[:, None].to(
        x.dtype)
    y = moe_combine(y_tok, r.order, t, k)
    if cfg.n_shared:
        if cfg.mlp == "swiglu":
            y = y + swiglu(xt, lp["s_gate"], lp["s_up"], lp["s_down"])
        else:
            y = y + gelu_mlp(xt, lp["s_up"], lp["s_down"])
    return y.reshape(b, s, d), r.aux


def mlp_block(cfg: LMConfig, lp: dict, x):
    if cfg.moe:
        return moe_block(cfg, lp, x)
    if cfg.mlp == "swiglu":
        return swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0
    return gelu_mlp(x, lp["w_up"], lp["w_down"]), 0.0


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: LMConfig, x, lp: dict, attn: str):
    a, _, _ = attention(cfg, lp, rms_norm(x, lp["ln1"]), attn=attn)
    x = x + a
    m, aux = mlp_block(cfg, lp, rms_norm(x, lp["ln2"]))
    return x + m, aux


def forward(cfg: LMConfig, params: dict, tokens, *, attn=None):
    """Prefill-style forward: tokens ``[B, S]`` -> (logits ``[B, S, V]``,
    aux loss averaged over the layers; 0.0 for a dense model).  With
    ``cfg.remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in backward, as the reference's ``jax.checkpoint``."""
    attn = resolve_attn(attn, tokens.device)
    x = params["embed"][tokens].to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer_fwd, cfg, x, lp, attn, use_reentrant=False)
        else:
            x, a = _layer_fwd(cfg, x, lp, attn)
        aux = aux + a
    x = rms_norm(x, params["ln_f"])
    return _logits(cfg, params, x), aux / cfg.n_layers


def loss_fn(cfg: LMConfig, params: dict, batch: dict):
    """Next-token cross entropy of ``batch["tokens"] [B, S]`` (mean over
    the ``S - 1`` predicted positions, or over those where the optional
    ``batch["mask"] [B, S]`` is set), plus the MoE aux loss.  Returns
    ``(loss + aux, {"loss", "aux"})``.  Attention is the plain path
    (``attn="plain"``): the flash kernel has no backward."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens, attn="plain")
    loss = softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
    mask = batch.get("mask")
    if mask is not None:
        m = mask[:, 1:]
        loss = (loss * m).sum() / m.sum().clamp_min(1)
    else:
        loss = loss.mean()
    return loss + aux, {"loss": loss, "aux": aux}


# --- serving ---------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, s_cache: int, device=None):
    """A zero cache of ``batch`` slots of ``s_cache`` positions on
    ``device`` (``None``: the card; without one this raises)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, s_cache, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(cfg: LMConfig, params: dict, tokens, s_cache: int,
            batch_chunks: int = 1, *, attn=None):
    """Run the prompt ``tokens [B, S]``; returns ``(cache, last_logits
    [B, V])`` with the cache zero past ``S`` and ``pos = S``.

    ``batch_chunks > 1`` runs the batch in that many sequential groups
    (chunked prefill in the batch dimension), bounding the attention
    working set to one group at a time.
    """
    b, s = tokens.shape
    if s > s_cache:
        raise ValueError("cache smaller than prompt")
    if batch_chunks > 1:
        if b % batch_chunks:
            raise ValueError(f"batch {b} is not {batch_chunks} equal chunks")
        g = b // batch_chunks
        parts = [prefill(cfg, params, tokens[i * g:(i + 1) * g], s_cache,
                         attn=attn) for i in range(batch_chunks)]
        cache = {key: torch.cat([c[key] for c, _ in parts],
                                dim=0 if key == "pos" else 1)
                 for key in ("k", "v", "pos")}
        return cache, torch.cat([lg for _, lg in parts])
    attn = resolve_attn(attn, tokens.device)
    cache = init_cache(cfg, b, s_cache, tokens.device)
    x = params["embed"][tokens].to(cfg.dtype)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        a, k, v = attention(cfg, lp, rms_norm(x, lp["ln1"]), attn=attn)
        x = x + a
        m, _ = mlp_block(cfg, lp, rms_norm(x, lp["ln2"]))
        x = x + m
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = rms_norm(x, params["ln_f"])
    cache["pos"].fill_(s)
    return cache, _logits(cfg, params, x[:, -1])


def ring_positions(pos, s_cache: int):
    """Absolute position of each slot of an ``s_cache``-slot ring buffer
    once each row's token at ``pos`` ``[B]`` is written: slots <= pos % S
    were (re)written this lap, slots beyond hold the previous lap, and
    negatives (never written in lap 0) are masked by the position >= 0
    test.  Returns int32 ``[B, s_cache]``."""
    base = torch.arange(s_cache, dtype=torch.int32, device=pos.device)
    laps = (pos[:, None] // s_cache) * s_cache + base[None, :]
    return torch.where(base[None, :] <= pos[:, None] % s_cache, laps,
                       laps - s_cache).to(torch.int32)


def decode_step(cfg: LMConfig, params: dict, cache: dict, tok, *,
                attn=None):
    """One decode step.  tok: ``[B]`` int.  Returns ``(logits [B, V],
    cache)``: the same cache dict, its K/V written in place at each
    slot's position and ``pos`` advanced by one.

    With ``cfg.attn_window == s_cache`` the cache is a ring buffer.
    Otherwise a slot at ``pos >= s_cache`` writes nothing and attends the
    whole cache, as the reference's dropped out-of-range scatter does.
    """
    attn = resolve_attn(attn, tok.device)
    b = tok.shape[0]
    s_cache = cache["k"].shape[2]
    pos = cache["pos"]                                       # [B] int32
    x = params["embed"][tok][:, None, :].to(cfg.dtype)       # [B, 1, D]

    if cfg.attn_window and s_cache == cfg.attn_window:
        write_at = pos % s_cache                             # ring buffer
        kv_positions = ring_positions(pos, s_cache)
    else:
        write_at = pos
        kv_positions = None                                  # slot t at t
    keep = (write_at < s_cache)[:, None, None]
    slot = write_at.clamp(max=s_cache - 1).long()
    rows = torch.arange(b, device=tok.device)
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kc, vc = cache["k"][i], cache["v"][i]                # [B, T, KV, HD]
        xn = rms_norm(x, lp["ln1"])
        q = (xn @ lp["wq"]).reshape(b, 1, kv, h // kv, hd)
        k = (xn @ lp["wk"]).reshape(b, 1, kv, hd)
        v = (xn @ lp["wv"]).reshape(b, 1, kv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"])
            k = rms_norm(k, lp["k_norm"])
        q = apply_rope(q.reshape(b, 1, h, hd), pos[:, None],
                       cfg.rope_theta).reshape(q.shape)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        kc[rows, slot] = torch.where(keep, k[:, 0], kc[rows, slot])
        vc[rows, slot] = torch.where(keep, v[:, 0], vc[rows, slot])
        if attn == "flash":
            out = flash_attention_pos(q, kc, vc, pos[:, None], kv_positions,
                                      causal=True, window=cfg.attn_window)
        else:
            tp = kv_positions
            if tp is None:
                tp = torch.arange(s_cache, dtype=torch.int32,
                                  device=tok.device).expand(b, s_cache)
            out = _sdpa_decode(cfg, q, kc, vc, pos, tp)
        x = x + out.reshape(b, 1, h * hd) @ lp["wo"]
        m, _ = mlp_block(cfg, lp, rms_norm(x, lp["ln2"]))
        x = x + m
    x = rms_norm(x, params["ln_f"])
    cache["pos"] = pos + 1
    return _logits(cfg, params, x[:, 0]), cache
