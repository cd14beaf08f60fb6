"""Synthetic LM, recsys and GNN data, the port's copy of the reference's
``repro.data.synthetic`` (``LMTokenStream``, ``RecsysStream``,
``gnn_node_classification``).

Deterministic (seeded) numpy batches with a step -> sample-offset mapping
(so a restarted job fast-forwards byte-identically, which
``train/failure.py`` relies on), byte-identical to the reference's for
the same arguments.
"""
from __future__ import annotations

import numpy as np


class LMTokenStream:
    """Synthetic token stream: Zipf unigrams with copied halves (so the
    loss falls during a run)."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        """``[batch, seq]`` int32 tokens: Zipf(1.3) draws mod ``vocab``,
        the second half of each row a copy of its first."""
        rng = np.random.default_rng((self.seed, step))
        base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
        toks = (base - 1) % self.vocab
        half = seq // 2
        toks[:, half:half * 2] = toks[:, :half]
        return toks.astype(np.int32)


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


def gnn_node_classification(n_nodes: int, n_edges: int, d_feat: int,
                            n_classes: int = 16, seed: int = 0,
                            with_pos: bool = False):
    """A random graph for full-batch node classification: ``n_edges``
    uniform edges (a self loop moved to the next vertex), symmetrised
    into ``2 * n_edges`` int32 ``senders``/``receivers``; normal float32
    ``node_feat`` ``[n_nodes, d_feat]``, uniform int32 ``labels`` and,
    with ``with_pos``, normal float32 ``pos`` ``[n_nodes, 3]``."""
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n_nodes, n_edges)
    rcv = rng.integers(0, n_nodes, n_edges)
    fix = snd == rcv
    rcv = np.where(fix, (rcv + 1) % n_nodes, rcv)
    senders = np.concatenate([snd, rcv]).astype(np.int32)
    receivers = np.concatenate([rcv, snd]).astype(np.int32)
    out = {
        "node_feat": rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32),
        "senders": senders,
        "receivers": receivers,
        "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
    }
    if with_pos:
        out["pos"] = rng.normal(0, 1, (n_nodes, 3)).astype(np.float32)
    return out
