"""Synthetic recsys traffic, the port's copy of the reference's
``repro.data.synthetic.RecsysStream``.

Deterministic (seeded) numpy batches with a step -> sample-offset mapping,
byte-identical to the reference's for the same ``(n_items, hist_len,
seed, step, batch)``.  The LM and GNN streams come with their slices.
"""
from __future__ import annotations

import numpy as np


class RecsysStream:
    """User-behaviour batches: Zipf item popularity, history + target."""

    def __init__(self, n_items: int, hist_len: int, seed: int = 0):
        self.n_items = n_items
        self.hist_len = hist_len
        self.seed = seed

    def batch(self, step: int, batch: int):
        """``{"hist": [B, L] int32, "hist_mask": [B, L] bool, "target":
        [B] int32}``; each history's first 50-100% of slots are real."""
        rng = np.random.default_rng((self.seed, step, 7))
        hist = (rng.zipf(1.2, size=(batch, self.hist_len)) - 1) % self.n_items
        lengths = rng.integers(self.hist_len // 2, self.hist_len + 1, batch)
        mask = np.arange(self.hist_len)[None, :] < lengths[:, None]
        target = (rng.zipf(1.2, size=batch) - 1) % self.n_items
        return {
            "hist": hist.astype(np.int32),
            "hist_mask": mask,
            "target": target.astype(np.int32),
        }
