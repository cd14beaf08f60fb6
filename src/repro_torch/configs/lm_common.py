"""Shared LM shape set (assigned to all 5 LM archs)."""
from __future__ import annotations

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "cache": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "cache": 524288, "batch": 1},
}
