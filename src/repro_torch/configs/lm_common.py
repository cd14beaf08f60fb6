"""Shared LM shape set + spec builders (assigned to all 5 LM archs)."""
from __future__ import annotations

import torch

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "cache": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "cache": 524288, "batch": 1},
}

SKIP_SHAPES = {"long_500k": "full attention"}


def token_struct(batch: int, seq: int, spec=None, mesh=None):
    """A ``[batch, seq]`` int32 token batch with no values: a ``meta``
    tensor, or with a ``parallel.sharding.Spec`` a DTensor over ``mesh``
    whose local shard is ``meta`` (the reference's ``ShapeDtypeStruct``
    with its sharding)."""
    if spec is None:
        return torch.empty((batch, seq), dtype=torch.int32, device="meta")
    from ..parallel.sharding import meta_dtensor
    return meta_dtensor((batch, seq), torch.int32, mesh, spec)
