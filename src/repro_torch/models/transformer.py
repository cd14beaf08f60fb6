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
The reference's ``_constrain(x, act_spec)`` is ``act_placements`` on
:func:`forward`, :func:`loss_fn` and :func:`prefill` (a DTensor
redistribution of the residual stream; nothing on plain tensors, so one
card is unchanged); :func:`decode_step` takes it and, as the
reference, does not use it.  On DTensors (the dry-run's cells) the
attention core, the MoE experts and the decode step's cache run on each
rank's local shards (:func:`_attention_sharded`, :func:`_moe_sharded`,
:class:`_CacheBlock`), through the same code as one card.

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
from ..parallel.dtensor_ops import constrain, is_dtensor, local_of, wrap
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


def _sdpa_decode(cfg: LMConfig, q, kc, vc, pos, kv_positions, group=None):
    """The reference decode step's inline attention: one query per slot
    at ``pos`` over the whole cache, keys at ``kv_positions``.  With a
    ``group`` (a DTensor cache whose positions are split over it) the
    cache is this rank's positions and the softmax is merged over the
    group by the row maximum, sum and weighted values (the split
    softmax of a flash decode)."""
    scores = torch.einsum("bskhd,btkd->bskht", q, kc).float()
    scores = scores / (cfg.hd ** 0.5)
    tp = kv_positions[:, None, None, None, :]
    qp = pos[:, None, None, None, None]
    mask = (tp <= qp) & (tp >= 0)
    if cfg.attn_window:
        mask = mask & (tp > qp - cfg.attn_window)
    scores = scores.masked_fill(~mask, float("-inf"))
    if group is None:
        probs = torch.softmax(scores, dim=-1)
        probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
        return torch.einsum("bskht,btkd->bskhd", probs.to(q.dtype), vc)
    from torch.distributed import _functional_collectives as funcol
    m = funcol.all_reduce(scores.amax(-1, keepdim=True), "max", group)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = funcol.all_reduce(p.sum(-1, keepdim=True), "sum", group)
    acc = funcol.all_reduce(torch.einsum(
        "bskht,btkd->bskhd", p.to(q.dtype), vc).float(), "sum", group)
    return (acc / torch.where(l > 0, l, 1.0)).to(q.dtype)


def attention(cfg: LMConfig, lp: dict, x, *, attn="plain"):
    """Causal self-attention block over the positions ``0..S-1`` of every
    row (the reference's ``attention`` as prefill and forward call it;
    the decode step attends over its cache itself).  x: ``[B, S, D]``.
    Returns ``(out [B, S, D], k, v)`` with the new keys (after RoPE) and
    values ``[B, S, KV, HD]``.  On DTensors the projections are
    DTensor matmuls and the rest runs on each rank's heads
    (:func:`_attention_sharded`)."""
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if is_dtensor(q):
        return _attention_sharded(cfg, lp, q, k, v, attn)
    out, k, v = _attend(cfg, lp, q, k, v, attn, cfg.n_heads, cfg.n_kv)
    return out @ lp["wo"], k, v


def _attend(cfg: LMConfig, lp: dict, q, k, v, attn: str, h: int, kv: int):
    """The attention of the projections ``q [B, S, h*HD]`` and ``k``,
    ``v [B, S, kv*HD]`` (``h`` query and ``kv`` key heads): qk-norm, RoPE
    at positions ``0..S-1`` and the causal core.  Returns ``(out [B, S,
    h*HD], k, v [B, S, kv, HD])``."""
    b, s = q.shape[:2]
    hd = cfg.hd
    q = q.reshape(b, s, kv, h // kv, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    positions = torch.arange(s, dtype=torch.int32, device=q.device).expand(
        b, s)
    q = apply_rope(q.reshape(b, s, h, hd), positions,
                   cfg.rope_theta).reshape(b, s, kv, h // kv, hd)
    k = apply_rope(k, positions, cfg.rope_theta)
    if attn == "flash":     # positions 0..S-1: a causal block stops early
        out = flash_attention_pos(q, k, v, causal=True,
                                  window=cfg.attn_window)
    elif s * s > (1 << 21) and q.device.type != "meta":
        # on ``meta`` (the dry-run's shape trace) the dense form stands
        # for the tiles: the same matmuls in one op instead of one a tile
        out = _sdpa_blockwise(cfg, q, k, v, positions, positions, True)
    else:
        out = _sdpa_dense(cfg, q, k, v, positions, positions, True)
    return out.reshape(b, s, h * hd), k, v


def _head_placements(cfg: LMConfig, t):
    """Placements for a ``[B, S, heads * HD]`` projection DTensor ``t``:
    its batch shards kept, heads split over ``model`` where both head
    counts divide that axis (whole query groups per rank), every other
    mesh dim replicated."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    msz = mesh.size(names.index("model")) if "model" in names else 1
    split = msz > 1 and cfg.n_kv % msz == 0 and cfg.n_heads % msz == 0
    out = []
    for name, p in zip(names, t.placements):
        if name == "model" and split:
            out.append(Shard(2))
        elif isinstance(p, Shard) and p.dim == 0:
            out.append(p)
        else:
            out.append(Replicate())
    return tuple(out), (msz if split else 1)


def _attention_sharded(cfg: LMConfig, lp: dict, q, k, v, attn: str):
    """:func:`attention` after the projections, on DTensors: ``q``, ``k``
    and ``v`` redistributed to :func:`_head_placements`, :func:`_attend`
    on each rank's local rows and heads, the output back as a DTensor
    for the ``wo`` matmul (the reference leaves this to XLA's
    partitioner)."""
    mesh = q.device_mesh
    places, div = _head_placements(cfg, q)
    q, k, v = (t.redistribute(mesh, places) for t in (q, k, v))
    norms = {n: local_of(lp[n]) for n in ("q_norm", "k_norm") if n in lp}
    out, kl, vl = _attend(cfg, norms, q.to_local(), k.to_local(),
                          v.to_local(), attn, cfg.n_heads // div,
                          cfg.n_kv // div)
    b, s = q.shape[:2]
    kv_shape = (b, s, cfg.n_kv, cfg.hd)
    out = wrap(out, mesh, places, (b, s, cfg.n_heads * cfg.hd))
    return (out @ lp["wo"], wrap(kl, mesh, places, kv_shape),
            wrap(vl, mesh, places, kv_shape))


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
    me, ce = _load_stats(cfg, probs, idx)
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


def _load_stats(cfg: LMConfig, probs, idx):
    """The aux loss's per-expert mean router probability ``p_e`` and
    share of the top-k choices ``f_e`` (``[E]`` each)."""
    me = probs.mean(0)
    ce = F.one_hot(idx, cfg.n_experts).sum(1).float().mean(0)
    return me, ce


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
    ``(y [B, S, D], aux)``; on a DTensor :func:`_moe_sharded`.  Padding
    tokens route like any other and use up capacity, as in the
    reference."""
    if is_dtensor(x):
        return _moe_sharded(cfg, lp, x)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    r = moe_route(cfg, lp, xt)
    y = _moe_experts(cfg, lp, xt, r)
    if cfg.n_shared:
        if cfg.mlp == "swiglu":
            y = y + swiglu(xt, lp["s_gate"], lp["s_up"], lp["s_down"])
        else:
            y = y + gelu_mlp(xt, lp["s_up"], lp["s_down"])
    return y.reshape(b, s, d), r.aux


def _moe_experts(cfg: LMConfig, w: dict, xt, r: Route, e0: int = 0):
    """The routed experts' sum for each token of ``xt [T, D]``: every
    kept (expert, rank) slot of the ``[E, cap, D]`` dispatch buffer is
    written once (dropped choices go to a spare row that is thrown
    away), the experts of ``w`` (``e_up [E_w, ...]``: experts ``e0 ..
    e0 + E_w``, every expert on one card) run as batched matmuls, and
    :func:`moe_combine` adds each token's gated rows; a choice of an
    expert outside ``w`` adds zero."""
    t, d = xt.shape
    e = cfg.n_experts
    e_w = w["e_up"].shape[0]
    slot = torch.where(r.keep, r.se * r.cap + r.rank, e * r.cap)
    buf = torch.zeros((e * r.cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((slot,), xt[r.st])[:-1].reshape(e, r.cap, d)
    if e_w != e:
        buf = buf[e0:e0 + e_w]
    if cfg.mlp == "swiglu":
        hidden = F.silu(torch.bmm(buf, w["e_gate"])) * torch.bmm(
            buf, w["e_up"])
    else:
        hidden = F.gelu(torch.bmm(buf, w["e_up"]), approximate="tanh")
    out_buf = torch.bmm(hidden, w["e_down"])
    if e_w != e:
        out_buf = F.pad(out_buf, (0, 0, 0, 0, e0, e - e0 - e_w))
    y_tok = out_buf[r.se, r.rank.clamp(max=r.cap - 1)]
    y_tok = torch.where(r.keep[:, None], y_tok, 0.0) * r.sg[:, None].to(
        xt.dtype)
    return moe_combine(y_tok, r.order, t, cfg.top_k)


def _moe_sharded(cfg: LMConfig, lp: dict, x):
    """:func:`moe_block` on a DTensor ``x``, rank by rank as
    expert-parallel layers run: each rank routes its own rows (split
    over the DP axes, whole over ``model``; capacity from its token
    count) and averages the load statistics over the DP ranks; the
    expert weights are gathered over every axis but ``model`` (FSDP),
    so a rank runs its block of experts (EP) or every expert on its
    slice of ``d_ff`` (expert-TP), and its output is a partial sum over
    ``model``."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)
    x = x.redistribute(mesh, rows)
    b, s, d = x.shape
    xt = x.to_local().reshape(-1, d)
    r = moe_route(cfg, {"router": local_of(lp["router"])}, xt)
    me, ce = _load_stats(cfg, r.probs, r.idx)
    for i, p in enumerate(rows):
        if isinstance(p, Shard):
            me = funcol.all_reduce(me, "sum", (mesh, i)) / mesh.size(i)
            ce = funcol.all_reduce(ce, "sum", (mesh, i)) / mesh.size(i)
    aux = cfg.aux_loss_coef * cfg.n_experts * torch.sum(me * ce)
    on_model = lambda t: tuple(p if n == "model" else Replicate()
                               for n, p in zip(names, t.placements))
    w = {n: lp[n].redistribute(mesh, on_model(lp[n])).to_local()
         for n in ("e_up", "e_down", "e_gate") if n in lp}
    e_w = w["e_up"].shape[0]
    e0 = mesh.get_local_rank("model") * e_w if e_w != cfg.n_experts else 0
    y = _moe_experts(cfg, w, xt, r, e0).reshape(x.to_local().shape)
    y = wrap(y, mesh, tuple(Partial() if isinstance(m, Shard) else p
                            for m, p in zip(on_model(lp["e_up"]), rows)),
             x.shape)
    aux = wrap(aux, mesh, (Replicate(),) * mesh.ndim, ())
    if cfg.n_shared:
        if cfg.mlp == "swiglu":
            y = y + swiglu(x, lp["s_gate"], lp["s_up"], lp["s_down"])
        else:
            y = y + gelu_mlp(x, lp["s_up"], lp["s_down"])
    return y, aux


def mlp_block(cfg: LMConfig, lp: dict, x):
    if cfg.moe:
        return moe_block(cfg, lp, x)
    if cfg.mlp == "swiglu":
        return swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0
    return gelu_mlp(x, lp["w_up"], lp["w_down"]), 0.0


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: LMConfig, x, lp: dict, attn: str, act_placements=None):
    a, _, _ = attention(cfg, lp, rms_norm(x, lp["ln1"]), attn=attn)
    x = constrain(x + a, act_placements)
    m, aux = mlp_block(cfg, lp, rms_norm(x, lp["ln2"]))
    return constrain(x + m, act_placements), aux


def forward(cfg: LMConfig, params: dict, tokens, *, attn=None,
            act_placements=None):
    """Prefill-style forward: tokens ``[B, S]`` -> (logits ``[B, S, V]``,
    aux loss averaged over the layers; 0.0 for a dense model).  With
    ``cfg.remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in backward, as the reference's ``jax.checkpoint``.

    ``act_placements``: DTensor placements of the ``[B, S, D]`` residual
    stream, applied after the embedding and after each residual add (the
    reference's ``act_spec`` constraint); ``None``, or plain tensors,
    leave it alone."""
    attn = resolve_attn(attn, tokens.device)
    if is_dtensor(tokens):
        act_placements = _rows_that_divide(act_placements,
                                           tokens.device_mesh,
                                           tokens.shape[0])
    x = constrain(params["embed"][tokens].to(cfg.dtype), act_placements)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer_fwd, cfg, x, lp, attn, act_placements,
                use_reentrant=False)
        else:
            x, a = _layer_fwd(cfg, x, lp, attn, act_placements)
        aux = aux + a
    x = rms_norm(x, params["ln_f"])
    return _logits(cfg, params, x), aux / cfg.n_layers


def loss_fn(cfg: LMConfig, params: dict, batch: dict, act_placements=None):
    """Next-token cross entropy of ``batch["tokens"] [B, S]`` (mean over
    the ``S - 1`` predicted positions, or over those where the optional
    ``batch["mask"] [B, S]`` is set), plus the MoE aux loss.  Returns
    ``(loss + aux, {"loss", "aux"})``.  Attention is the plain path
    (``attn="plain"``): the flash kernel has no backward."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens, attn="plain",
                          act_placements=act_placements)
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
            batch_chunks: int = 1, *, attn=None, act_placements=None):
    """Run the prompt ``tokens [B, S]``; returns ``(cache, last_logits
    [B, V])`` with the cache zero past ``S`` and ``pos = S``.

    ``batch_chunks > 1`` runs the batch in that many sequential groups
    (chunked prefill in the batch dimension), bounding the attention
    working set to one group at a time.  ``act_placements`` as in
    :func:`forward`.  On DTensor tokens the cache is made of the
    layers' keys and values (DTensors, placed as the attention left
    them) instead of written into a zero cache.
    """
    b, s = tokens.shape
    if s > s_cache:
        raise ValueError("cache smaller than prompt")
    if batch_chunks > 1:
        if b % batch_chunks:
            raise ValueError(f"batch {b} is not {batch_chunks} equal chunks")
        g = b // batch_chunks
        parts = [prefill(cfg, params, tokens[i * g:(i + 1) * g], s_cache,
                         attn=attn, act_placements=act_placements)
                 for i in range(batch_chunks)]
        cache = {key: torch.cat([c[key] for c, _ in parts],
                                dim=0 if key == "pos" else 1)
                 for key in ("k", "v", "pos")}
        return cache, torch.cat([lg for _, lg in parts])
    attn = resolve_attn(attn, tokens.device)
    sharded = is_dtensor(tokens)
    if sharded:
        act_placements = _rows_that_divide(act_placements,
                                           tokens.device_mesh, b)
    else:
        cache = init_cache(cfg, b, s_cache, tokens.device)
    kvs = []
    x = constrain(params["embed"][tokens].to(cfg.dtype), act_placements)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        a, k, v = attention(cfg, lp, rms_norm(x, lp["ln1"]), attn=attn)
        x = constrain(x + a, act_placements)
        m, _ = mlp_block(cfg, lp, rms_norm(x, lp["ln2"]))
        x = constrain(x + m, act_placements)
        if sharded:
            kvs.append((k, v))
        else:
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
    x = rms_norm(x, params["ln_f"])
    if sharded:
        cache = {key: torch.stack([kv[j] for kv in kvs])
                 for j, key in enumerate(("k", "v"))}
        if s < s_cache:
            cache = {key: F.pad(t, (0, 0, 0, 0, 0, s_cache - s))
                     for key, t in cache.items()}
        cache["pos"] = torch.full_like(tokens[:, 0], s, dtype=torch.int32)
    else:
        cache["pos"].fill_(s)
    return cache, _logits(cfg, params, x[:, -1])


def _rows_that_divide(places, mesh, rows: int):
    """``places`` with dim 0 split only over the mesh dims (in order)
    whose running product divides ``rows``; the rest of dim 0's splits
    replicated (a chunk of fewer rows than ranks is computed whole on
    the ranks that would split it unevenly)."""
    from torch.distributed.tensor import Replicate, Shard

    if places is None:
        return None
    out, k = [], 1
    for i, p in enumerate(places):
        if isinstance(p, Shard) and p.dim == 0:
            if rows % (k * mesh.size(i)) == 0:
                k *= mesh.size(i)
            else:
                p = Replicate()
        out.append(p)
    return tuple(out)


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
                attn=None, act_placements=None):
    """One decode step.  tok: ``[B]`` int.  Returns ``(logits [B, V],
    cache)``: the same cache dict, its K/V written in place at each
    slot's position and ``pos`` advanced by one.

    With ``cfg.attn_window == s_cache`` the cache is a ring buffer.
    Otherwise a slot at ``pos >= s_cache`` writes nothing and attends the
    whole cache, as the reference's dropped out-of-range scatter does.

    ``act_placements`` is accepted and unused, as the reference's
    ``act_spec`` here.  A DTensor cache may have its batch and positions
    split (``lm_cache_specs``): each rank writes the slots its block
    holds and attends over its positions, merged by :func:`_sdpa_decode`
    over the ranks that share a row.
    """
    del act_placements
    attn = resolve_attn(attn, tok.device)
    b = tok.shape[0]
    s_cache = cache["k"].shape[2]
    blk = _CacheBlock(cache["k"])
    pos = blk.rows(cache["pos"])                             # [B] int32
    kc_all, vc_all = blk.local(cache["k"]), blk.local(cache["v"])
    x = params["embed"][tok][:, None, :].to(cfg.dtype)       # [B, 1, D]

    p0, s_loc = blk.p0, kc_all.shape[2]
    if cfg.attn_window and s_cache == cfg.attn_window:
        write_at = pos % s_cache                             # ring buffer
        kv_positions = ring_positions(pos, s_cache)[:, p0:p0 + s_loc]
    else:
        write_at = pos
        kv_positions = None                                  # slot t at t
    at = write_at - p0
    keep = ((write_at < s_cache) & (at >= 0) & (at < s_loc))[:, None, None]
    slot = at.clamp(0, max(s_loc - 1, 0)).long()
    b_loc = pos.shape[0]
    rows = torch.arange(b_loc, device=pos.device)
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kc, vc = kc_all[i], vc_all[i]                        # [B, T, KV, HD]
        xn = rms_norm(x, lp["ln1"])
        q = blk.rows(xn @ lp["wq"]).reshape(b_loc, 1, kv, h // kv, hd)
        k = blk.rows(xn @ lp["wk"]).reshape(b_loc, 1, kv, hd)
        v = blk.rows(xn @ lp["wv"]).reshape(b_loc, 1, kv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, local_of(lp["q_norm"]))
            k = rms_norm(k, local_of(lp["k_norm"]))
        q = apply_rope(q.reshape(b_loc, 1, h, hd), pos[:, None],
                       cfg.rope_theta).reshape(q.shape)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        if s_loc:
            kc[rows, slot] = torch.where(keep, k[:, 0], kc[rows, slot])
            vc[rows, slot] = torch.where(keep, v[:, 0], vc[rows, slot])
        if attn == "flash" and blk.mesh is None:
            out = flash_attention_pos(q, kc, vc, pos[:, None], kv_positions,
                                      causal=True, window=cfg.attn_window)
        else:
            tp = kv_positions
            if tp is None:
                tp = torch.arange(p0, p0 + s_loc, dtype=torch.int32,
                                  device=pos.device).expand(b_loc, s_loc)
            out = _sdpa_decode(cfg, q, kc, vc, pos, tp, blk.group)
        out = blk.whole(out.reshape(b_loc, 1, h * hd), (b, 1, h * hd))
        x = x + out @ lp["wo"]
        m, _ = mlp_block(cfg, lp, rms_norm(x, lp["ln2"]))
        x = x + m
    x = rms_norm(x, params["ln_f"])
    cache["pos"] = cache["pos"] + 1
    return _logits(cfg, params, x[:, 0]), cache


class _CacheBlock:
    """This rank's block of a ``[L, B, S_cache, KV, HD]`` cache for
    :func:`decode_step`: ``p0`` its first position, ``group`` the mesh
    dim its positions are split over (``None``: every position here),
    :meth:`rows` a ``[B, ...]`` tensor's rows of the block, :meth:`local`
    the block itself and :meth:`whole` a block's rows back as a DTensor.
    A plain cache is one block: ``p0 = 0`` and the methods return their
    argument."""

    def __init__(self, kc):
        self.mesh, self.group, self.p0 = None, None, 0
        if not is_dtensor(kc):
            return
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        places = kc.placements
        if any(isinstance(p, Shard) and p.dim not in (1, 2)
               for p in places):
            raise ValueError(f"cache placements {places}: only the batch "
                             "and positions may be sharded")
        seq = [i for i, p in enumerate(places)
               if isinstance(p, Shard) and p.dim == 2]
        if len(seq) > 1:
            raise ValueError("positions sharded over more than one mesh dim")
        self.mesh = kc.device_mesh
        self.group = (self.mesh, seq[0]) if seq else None
        self.p0 = compute_local_shape_and_global_offset(
            tuple(kc.shape), self.mesh, tuple(places))[1][2]
        self.row_places = tuple(Shard(0) if isinstance(p, Shard) and
                                p.dim == 1 else Replicate() for p in places)

    def rows(self, t):
        if self.mesh is None:
            return t
        return t.redistribute(self.mesh, self.row_places).to_local()

    def local(self, t):
        return t if self.mesh is None else t.to_local()

    def whole(self, t, shape):
        if self.mesh is None:
            return t
        return wrap(t, self.mesh, self.row_places, shape)
