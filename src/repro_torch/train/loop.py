"""Train-step builders with microbatch accumulation, the port's copy of
``repro.train.loop`` for the LM, GNN and MIND families.

``make_*_train_step`` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``, functional as the reference's jitted
step: gradients by ``torch.autograd`` on detached copies of the
parameter leaves, then the optimizer.  The batch (a dict of tensors or
numpy arrays, or a GNN ``GraphBatch``) is moved to the parameters'
device.  Accumulation over microbatches is a Python loop (one
microbatch's activations live at a time), the reference's ``lax.scan``.
``make_lm_train_step``'s ``act_placements`` is the reference's
``act_spec`` (DTensor placements of the residual stream; nothing for
plain tensors).  DTensor parameters and batches (the dry-run's cells)
run the same code.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import transformer
from ..models.gnn import common as gnn_common
from ..models.recsys import mind as mind_mod
from ..parallel.dtensor_ops import is_dtensor
from . import optimizer as opt_mod
from .tree import leaves, tree_map, unflatten


def _on_device(batch, device):
    if isinstance(batch, gnn_common.GraphBatch):
        return batch.to(device)
    return {k: v if is_dtensor(v) else torch.as_tensor(
        np.asarray(v) if not isinstance(v, torch.Tensor) else v,
        device=device) for k, v in batch.items()}


def _split(v, microbatches: int):
    """The ``microbatches`` equal leading-dim parts of ``v``.  A DTensor
    whose local rows split evenly is split rank by rank (each part keeps
    the placements; microbatch ``i`` holds every rank's ``i``-th local
    part, a mean over the same rows); otherwise by global slices."""
    b = v.shape[0]
    m = b // microbatches
    if is_dtensor(v):
        from ..parallel.dtensor_ops import wrap
        loc = v.to_local()
        if loc.shape[0] % microbatches == 0:
            lm = loc.shape[0] // microbatches
            return [wrap(loc[i * lm:(i + 1) * lm], v.device_mesh,
                         v.placements, (m, *v.shape[1:]))
                    for i in range(microbatches)]
        return [v[i * m:(i + 1) * m] for i in range(microbatches)]
    split = v.reshape(microbatches, m, *v.shape[1:])
    return [split[i] for i in range(microbatches)]


def value_and_grad(loss_fn, params, batch):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``: the gradient of every parameter leaf in its own dtype
    (zeros where the loss does not reach it, as JAX gives), the loss and
    metrics detached."""
    flat = leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    detach = lambda x: x.detach() if isinstance(x, torch.Tensor) else x
    return (loss.detach(), {k: detach(v) for k, v in metrics.items()},
            unflatten(params, grads))


def _accumulate(loss_fn, params, batch: dict, microbatches: int):
    """Mean-gradient accumulation over ``microbatches`` equal leading-dim
    splits of ``batch``: f32 gradients summed from zero in microbatch
    order, then divided; one microbatch returns its own gradients and
    metrics."""
    if microbatches <= 1:
        return value_and_grad(loss_fn, params, batch)
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} is not {microbatches} equal "
                         "microbatches")
    split = {k: _split(v, microbatches) for k, v in batch.items()}
    acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
    for i in range(microbatches):
        loss, _, grads = value_and_grad(
            loss_fn, params, {k: v[i] for k, v in split.items()})
        acc = tree_map(torch.add, acc, grads)
        loss_sum = loss_sum + loss
    grads = tree_map(lambda g: g / microbatches, acc)
    loss = loss_sum / microbatches
    return loss, {"loss": loss}, grads


def _step(loss_fn, opt_cfg, microbatches: int):
    def step(params, opt_state, batch):
        batch = _on_device(batch, leaves(params)[0].device)
        loss, metrics, grads = _accumulate(loss_fn, params, batch,
                                           microbatches)
        params, opt_state, om = opt_mod.adamw_update(params, grads,
                                                     opt_state, opt_cfg)
        return params, opt_state, {**metrics, **om}
    return step


def make_lm_train_step(cfg: transformer.LMConfig,
                       opt_cfg: opt_mod.AdamWConfig, act_placements=None,
                       microbatches: int = 1):
    """AdamW on :func:`transformer.loss_fn` (plain attention) over
    ``{"tokens": [B, S], "mask": [B, S] (optional)}`` batches."""
    return _step(lambda p, b: transformer.loss_fn(cfg, p, b, act_placements),
                 opt_cfg, microbatches)


def make_gnn_train_step(forward, cfg, opt_cfg, graph_level: bool = False,
                        microbatches: int = 1):
    """AdamW on ``forward(cfg, params, gb) -> logits`` with cross entropy
    on ``gb.labels`` (node or graph level alike, as the reference's two
    branches).  ``microbatches`` is accepted and unused, as in the
    reference: a graph batch is one full batch."""
    del graph_level, microbatches

    def loss_fn(params, gb):
        loss = gnn_common.node_ce_loss(forward(cfg, params, gb), gb.labels)
        return loss, {"loss": loss}
    return _step(loss_fn, opt_cfg, 1)


def make_gnn_regression_step(forward, cfg, opt_cfg):
    """AdamW on the mean squared error of ``forward(cfg, params, gb)``
    against ``gb.labels`` (graph-level regression, the molecule shape)."""
    def loss_fn(params, gb):
        pred = forward(cfg, params, gb)
        loss = torch.mean((pred.reshape(-1) -
                           gb.labels.to(torch.float32).reshape(-1)) ** 2)
        return loss, {"loss": loss}
    return _step(loss_fn, opt_cfg, 1)


def make_mind_train_step(cfg: mind_mod.MINDConfig, opt_cfg,
                         microbatches: int = 1):
    """AdamW on :func:`mind.train_loss` over ``{"hist", "hist_mask",
    "target"}`` batches (:class:`~repro_torch.data.synthetic.
    RecsysStream`'s)."""
    return _step(lambda p, b: mind_mod.train_loss(cfg, p, b), opt_cfg,
                 microbatches)
