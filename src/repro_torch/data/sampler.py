"""Neighbour sampler for minibatch GNN training (GraphSAGE-style fanout),
the port's copy of ``repro.data.sampler``.

Per-layer uniform neighbour sampling from a CSR adjacency, producing a
block-diagonal computation subgraph with static shapes (pad + mask).
Used by the ``minibatch_lg`` shape (batch_nodes=1024, fanout 15-10).
Numpy: this is data preparation, not device work.  The same CSR, fanouts
and seed give the reference's arrays, dtypes included (int32 block
indices, int64 node ids).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SampledBlock(NamedTuple):
    """One message-passing block: edges from sampled srcs -> seed dsts."""
    senders: np.ndarray    # [E_pad] int32 (index into this block's src set)
    receivers: np.ndarray  # [E_pad] int32 (index into the dst/seed set)
    edge_mask: np.ndarray  # [E_pad] bool
    src_nodes: np.ndarray  # [S_pad] global node id
    dst_nodes: np.ndarray  # [D] global node id (seeds of this layer)
    src_mask: np.ndarray   # [S_pad] bool


class SampledBatch(NamedTuple):
    blocks: tuple           # outermost layer first
    seeds: np.ndarray       # [batch] global ids (training targets)
    input_nodes: np.ndarray  # global ids of the innermost src set


class NeighborSampler:
    def __init__(self, row_ptr: np.ndarray, col: np.ndarray, fanouts,
                 seed: int = 0):
        self.row_ptr = row_ptr
        self.col = col
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int):
        """Uniform with-replacement fanout sampling (standard GraphSAGE)."""
        deg = self.row_ptr[nodes + 1] - self.row_ptr[nodes]
        has = deg > 0
        # sample fanout slots per node; nodes with deg==0 are masked
        offs = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                 (nodes.shape[0], fanout))
        idx = self.row_ptr[nodes][:, None] + offs
        nbrs = self.col[idx]                        # [n, fanout]
        mask = np.broadcast_to(has[:, None], nbrs.shape)
        return nbrs, mask

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        blocks = []
        dst = seeds.astype(np.int64)
        for fanout in self.fanouts:
            nbrs, mask = self._sample_neighbors(dst, fanout)
            flat_src = nbrs.reshape(-1)
            flat_mask = mask.reshape(-1)
            # unique src set (+ keep dst nodes for self loops upstream)
            uniq, inv = np.unique(
                np.concatenate([dst, flat_src]), return_inverse=True)
            dst_local = inv[:dst.shape[0]]
            src_local = inv[dst.shape[0]:]
            receivers = np.repeat(np.arange(dst.shape[0], dtype=np.int64),
                                  fanout)
            blocks.append(SampledBlock(
                senders=src_local.astype(np.int32),
                receivers=receivers.astype(np.int32),
                edge_mask=flat_mask,
                src_nodes=uniq.astype(np.int64),
                dst_nodes=dst,
                src_mask=np.ones(uniq.shape[0], bool),
            ))
            dst = uniq
        return SampledBatch(blocks=tuple(blocks), seeds=seeds,
                            input_nodes=dst)


def flat_subgraph(batch: SampledBatch, pad_nodes: int, pad_edges: int):
    """Collapse sampled blocks into one padded homogeneous subgraph
    (node-reindexed union of all block edges) for single-graph GNN code.
    Nodes and edges past ``pad_nodes``/``pad_edges`` are dropped.

    Returns ``(senders, receivers, edge_mask, node_ids, node_mask)``."""
    nodes = batch.input_nodes
    id_map = {int(g): i for i, g in enumerate(nodes)}
    snd, rcv = [], []
    for blk in batch.blocks:
        s_glob = blk.src_nodes[blk.senders]
        d_glob = blk.dst_nodes[blk.receivers]
        keep = blk.edge_mask
        for sg, dg in zip(s_glob[keep], d_glob[keep]):
            snd.append(id_map[int(sg)])
            rcv.append(id_map[int(dg)])
    n = min(len(nodes), pad_nodes)
    e = min(len(snd), pad_edges)
    senders = np.zeros(pad_edges, np.int32)
    receivers = np.zeros(pad_edges, np.int32)
    emask = np.zeros(pad_edges, bool)
    senders[:e] = snd[:e]
    receivers[:e] = rcv[:e]
    emask[:e] = True
    node_ids = np.zeros(pad_nodes, np.int64)
    node_ids[:n] = nodes[:n]
    nmask = np.zeros(pad_nodes, bool)
    nmask[:n] = True
    return senders, receivers, emask, node_ids, nmask
