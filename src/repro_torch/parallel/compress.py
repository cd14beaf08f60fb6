"""Gradient compression for cross-pod data parallelism, the port's copy
of ``repro.parallel.compress``.

int8 uniform quantization with error feedback (EF-SGD style): each rank
quantizes its local gradient to int8 + per-tensor scale, all-reduces the
int8 payload (summed in int32), and keeps the quantization residual
locally, adding it back into the next step's gradient.

The reference runs inside a ``shard_map`` over the DP axes and names the
axis; here :func:`compressed_psum` takes a ``torch.distributed`` process
group (``None``: the default group), every rank calling it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..train.tree import leaves, tree_map, unflatten


def quantize(x, bits: int = 8):
    """Symmetric per-tensor quantization -> (int8 payload, f32 scale)."""
    x = x.to(torch.float32)
    amax = torch.max(torch.abs(x))
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(grad, group=None, error=None, bits: int = 8):
    """EF-compressed all-reduce of one gradient tensor over ``group``.

    Returns (mean_grad, new_error): the int32 sum of every rank's int8
    payload times the mean of the scales, over the rank count, and this
    rank's quantization residual."""
    g = grad.to(torch.float32)
    if error is not None:
        g = g + error
    q, scale = quantize(g, bits)
    new_error = g - dequantize(q, scale)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    sum_scale = scale.clone()
    dist.all_reduce(sum_scale, op=dist.ReduceOp.SUM, group=group)
    n = torch.ones((), dtype=torch.float32, device=g.device)
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=group)
    # each rank contributed ~q*scale; approximate the sum with the mean
    # scale
    mean_scale = sum_scale / n
    return total.to(torch.float32) * mean_scale / n, new_error


def compressed_tree_psum(grads, group=None, errors=None, bits: int = 8):
    """Tree version; the errors tree matches grads (or None: zeros)."""
    if errors is None:
        errors = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device), grads)
    outs = [compressed_psum(g, group, e, bits)
            for g, e in zip(leaves(grads), leaves(errors))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))
