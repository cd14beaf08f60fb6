"""Shared neural-net building blocks in PyTorch.

Parameters are plain dicts of tensors; every init function takes an
explicit ``torch.Generator`` (on the device the tensor is made on) and
returns a tensor in the requested dtype.  Compute runs in the tensors'
dtype (bf16 for the full-size models) with f32 normalisation statistics
and f32 rotary angles, as in the reference ``repro.models.layers``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None, *, lead=()):
    """Truncated-normal (-2, 2) fan-in init times ``scale`` (default
    ``1/sqrt(d_in)``), drawn in f32 on ``gen``'s device; ``lead`` prepends
    stacking dimensions (one matrix per layer).

    The leading index ``lead[0]`` is drawn one slice at a time into a
    stack allocated in ``dtype``, so the f32 temporary is one slice (one
    layer's matrix, or one layer's expert block), never the whole stack:
    granite-34b's ``w_up`` stack is 26.6 GB in bf16 and would need 53 GB
    more as one f32 draw."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    out = torch.empty((*lead, d_in, d_out), dtype=dtype, device=gen.device)
    for part in (out.unbind(0) if lead else (out,)):
        w = torch.empty(part.shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(w * std)
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with f32 statistics."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm with f32 statistics (the population variance)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    """Rotary embedding inverse frequencies ``[head_dim // 2]`` (f32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 1e4):
    """Apply rotary embedding.  x: ``[..., seq, n_heads, head_dim]``,
    positions: broadcastable to ``[..., seq]``; f32 angles."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_up, w_down):
    """Two-matrix MLP with the tanh-approximate GELU (``jax.nn.gelu``'s
    default)."""
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


def softmax_cross_entropy(logits, labels, z_loss: float = 0.0):
    """Per-position cross entropy ``logsumexp(logits) - logits[label]``
    with an f32 logsumexp, plus ``z_loss * logsumexp**2`` when
    ``z_loss``; labels ``[...]`` int, logits ``[..., V]``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss
