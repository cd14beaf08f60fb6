"""Decoder-only transformer LM (dense) in PyTorch: forward, prefill and
the decode step of the serving path.

Port of ``repro.models.transformer`` for inference on one card: GQA
attention with an explicit ``head_dim``, RoPE applied before the cache
(absolute positions, so a ring buffer serves sliding-window decode),
optional qk-norm, SwiGLU or GELU MLP, tied or separate LM head.  Not
here: the reference's ``_constrain``/``act_spec``, ``seq_shard`` and
``remat`` (sharding and autodiff hooks that inference on one card does
not need), its ``lax.scan`` over stacked layers (a Python loop over the
same stacked parameters), the MoE block and ``loss_fn``, which come with
later slices (ROADMAP.md, queue 1 item 11).

Attention runs one of two implementations, named by ``attn``:

* ``"flash"``: ``kernels/flash_attn``'s :func:`flash_attention_pos`, the
  hand-written CUDA kernel on the card (its plain f32 version on the
  CPU), reading the cache in place;
* ``"plain"``: the reference's own attention translated op for op
  (:func:`_sdpa_dense`, :func:`_sdpa_blockwise` above ``s * t > 2**21``,
  and the decode step's :func:`_sdpa_decode`), with the reference's bf16
  roundings of scores and probabilities.

``attn=None`` takes ``"flash"`` on a CUDA device and ``"plain"`` on the
CPU; nothing switches from one to the other on its own.

The KV cache is ``{"k", "v": [L, B, S_cache, KV, HD], "pos": [B]}``;
:func:`decode_step` writes the new keys and values into it in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..core.sssp import resolve_device
from ..kernels.flash_attn.ops import flash_attention_pos
from .layers import apply_rope, dense_init, embed_init, gelu_mlp, rms_norm, \
    swiglu

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
    # MoE (the configuration is expressible; the block is not ported yet)
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # attention
    attn_window: int = 0              # 0 => full causal
    tied_embed: bool = False          # lm_head = embed.T (qwen3, phi4)
    # numerics
    dtype: Any = torch.bfloat16

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

def _no_moe(cfg: LMConfig):
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers (moe_block) are not ported yet; they "
            "come with a later slice (ROADMAP.md, queue 1 item 11.2)")


def init_params(cfg: LMConfig, gen: torch.Generator) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on its device: per-layer tensors stacked on a leading
    ``n_layers`` axis, norms at one."""
    _no_moe(cfg)
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
    layer["w_up"] = dense_init(gen, d, cfg.d_ff, dt, **stack)
    layer["w_down"] = dense_init(gen, cfg.d_ff, d, dt, out_scale(cfg.d_ff),
                                 **stack)
    if cfg.mlp == "swiglu":
        layer["w_gate"] = dense_init(gen, d, cfg.d_ff, dt, **stack)
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
# attention / mlp blocks
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


def mlp_block(cfg: LMConfig, lp: dict, x):
    _no_moe(cfg)
    if cfg.mlp == "swiglu":
        return swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0
    return gelu_mlp(x, lp["w_up"], lp["w_down"]), 0.0


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward(cfg: LMConfig, params: dict, tokens, *, attn=None):
    """Prefill-style forward: tokens ``[B, S]`` -> (logits ``[B, S, V]``,
    aux loss)."""
    attn = resolve_attn(attn, tokens.device)
    x = params["embed"][tokens].to(cfg.dtype)
    aux = 0.0
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        a, _, _ = attention(cfg, lp, rms_norm(x, lp["ln1"]), attn=attn)
        x = x + a
        m, a_mlp = mlp_block(cfg, lp, rms_norm(x, lp["ln2"]))
        x = x + m
        aux += a_mlp
    x = rms_norm(x, params["ln_f"])
    return _logits(cfg, params, x), aux / cfg.n_layers


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
