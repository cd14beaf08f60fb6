"""Optimizers over nested parameter trees, the port's copy of
``repro.train.optimizer``.

AdamW with:
  * f32 first and second moments and optional f32 master weights (params
    may be bf16: the usual mixed-precision recipe),
  * global-norm gradient clipping,
  * linear warmup then cosine decay, the bias corrections ``b ** step``
    in f32;
and SGD with momentum.  States are trees mirroring the parameter tree,
with ``step`` an int32 scalar on the parameters' device.  Every function
is functional (nothing is updated in place) and runs where the tensors
lie.  ``torch.optim.AdamW`` is not used: its eps placement, schedule and
clipping differ from the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    master_weights: bool = True


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or an integer tensor), f32:
    linear warmup over ``warmup_steps``, then a cosine decay to
    ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = (step / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    t = ((step - cfg.warmup_steps) /
         max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _device(params):
    return leaves(params)[0].device


def adamw_init(params, cfg: AdamWConfig) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}
    if cfg.master_weights:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree):
    """``sqrt`` of the sum of every leaf's f32 sum of squares, leaf sums
    added in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _clip_scale(gnorm, clip_norm: float):
    if not clip_norm:
        return 1.0
    return (clip_norm / gnorm.clamp_min(1e-9)).clamp(max=1.0)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step: returns ``(params, state, {"lr", "grad_norm"})``,
    the new parameters in their own dtypes (from the f32 master weights
    when the state holds them)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    ref = state.get("master", params)

    def upd(p_ref, g, m, v):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m2 / b1c
        vh = v2 / b2c
        p32 = p_ref.float()
        p2 = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                         + cfg.weight_decay * p32)
        return p2, m2, v2

    outs = [upd(*args) for args in zip(leaves(ref), leaves(grads),
                                       leaves(state["m"]),
                                       leaves(state["v"]))]
    new_ref = unflatten(ref, [o[0] for o in outs])
    new_state = {"m": unflatten(ref, [o[1] for o in outs]),
                 "v": unflatten(ref, [o[2] for o in outs]), "step": step}
    new_params = tree_map(lambda p32, p: p32.to(p.dtype), new_ref, params)
    if "master" in state:
        new_state["master"] = new_ref
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    momentum: float = 0.9
    clip_norm: float = 0.0


def sgd_init(params, cfg: SGDConfig) -> dict:
    return {"mom": tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


@torch.no_grad()
def sgd_update(params, grads, state: dict, cfg: SGDConfig):
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    new_mom = tree_map(lambda m, g: cfg.momentum * m + g.float() * scale,
                       state["mom"], grads)
    new_params = tree_map(
        lambda p, m: (p.float() - cfg.lr * m).to(p.dtype), params, new_mom)
    return new_params, {"mom": new_mom, "step": state["step"] + 1}, {
        "grad_norm": gnorm}
