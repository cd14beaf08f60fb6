"""Graph generators (numpy; port of ``repro.data.generators``).

* :func:`kronecker` — Graph500-style RMAT/Kronecker generator
  (A=0.57, B=0.19, C=0.19, D=0.05), edge weights uniform in (0, 1].
* :func:`uniform_random` — Urand-style Erdős–Rényi with fixed edge count.
* :func:`road_grid`  — 2D lattice with local weights (Road-like: huge
  diameter, degree <= 4).
* :func:`molecule_batch` — batched small graphs (GNN `molecule` shape).

Each graph generator draws an undirected edge list from a numpy seed and
builds it with :func:`repro_torch.core.graph.build_csr`, so the same seed
gives the same arrays as the reference package.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import HostGraph, build_csr

RMAT_A, RMAT_B, RMAT_C, RMAT_D = 0.57, 0.19, 0.19, 0.05


def _resample_exact(m: int, draw) -> tuple:
    """Draw (u, v) endpoint batches via ``draw(k)`` until exactly ``m``
    non-self-loop edges accumulate (generators previously under-delivered
    by however many self loops they happened to draw)."""
    us = [np.zeros(0, np.int64)]
    vs = [np.zeros(0, np.int64)]
    have = 0
    while have < m:
        u, v = draw(m - have)
        keep = u != v
        u, v = u[keep], v[keep]
        us.append(u)
        vs.append(v)
        have += u.shape[0]
    return np.concatenate(us)[:m], np.concatenate(vs)[:m]


def _rmat_pairs(rng, m: int, scale: int) -> tuple:
    """One batch of m RMAT endpoint pairs (may contain self loops)."""
    u = np.zeros(m, np.int64)
    v = np.zeros(m, np.int64)
    ab = RMAT_A + RMAT_B
    c_norm = RMAT_C / (RMAT_C + RMAT_D)
    a_norm = RMAT_A / ab
    for bit in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        u_bit = r1 > ab
        v_bit = np.where(u_bit, r2 > c_norm, r2 > a_norm)
        u |= u_bit.astype(np.int64) << bit
        v |= v_bit.astype(np.int64) << bit
    return u, v


def kronecker(scale: int, edge_factor: int, seed: int = 0,
              weights: str = "uniform") -> HostGraph:
    """Graph500 Kronecker generator: 2^scale vertices, edge_factor*2^scale edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    if n < 2 and m > 0:
        raise ValueError("need scale >= 1 to draw non-self-loop edges")
    u, v = _resample_exact(m, lambda k: _rmat_pairs(rng, k, scale))
    # Graph500 permutes vertex labels to break locality
    perm = rng.permutation(n)
    u, v = perm[u], perm[v]
    w = _gen_weights(rng, m, weights)
    return build_csr(n, u, v, w)


def uniform_random(n: int, m: int, seed: int = 0,
                   weights: str = "uniform") -> HostGraph:
    """Urand-style: m undirected edges with uniformly random endpoints."""
    if n < 2 and m > 0:
        raise ValueError("need n >= 2 to draw non-self-loop edges")
    rng = np.random.default_rng(seed)
    u, v = _resample_exact(
        m, lambda k: (rng.integers(0, n, k), rng.integers(0, n, k)))
    w = _gen_weights(rng, m, weights)
    return build_csr(n, u, v, w)


def road_grid(side: int, seed: int = 0, diag: bool = False) -> HostGraph:
    """2D lattice (Road-like: degree <= 4, diameter ~ 2*side)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(side * side).reshape(side, side)
    eu = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    ev = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    if diag:
        eu.append(idx[:-1, :-1].ravel())
        ev.append(idx[1:, 1:].ravel())
    u = np.concatenate(eu)
    v = np.concatenate(ev)
    w = rng.uniform(0.1, 1.0, u.shape[0])  # road weights: narrow band
    return build_csr(side * side, u, v, w)


def molecule_batch(n_nodes: int = 30, n_edges: int = 64, batch: int = 128,
                   seed: int = 0):
    """Batched random small graphs: ``senders``/``receivers`` ``[batch,
    n_edges]`` int32 (no self loops), 3D ``pos`` ``[batch, n_nodes, 3]``
    float32 for geometric models (DimeNet) and an all-true ``node_mask``;
    the reference's arrays for the same seed."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n_nodes, (batch, n_edges))
    receivers = rng.integers(0, n_nodes, (batch, n_edges))
    fix = senders == receivers
    receivers = np.where(fix, (receivers + 1) % n_nodes, receivers)
    pos = rng.normal(0, 1, (batch, n_nodes, 3)).astype(np.float32)
    return {
        "senders": senders.astype(np.int32),
        "receivers": receivers.astype(np.int32),
        "pos": pos,
        "node_mask": np.ones((batch, n_nodes), bool),
    }


def _gen_weights(rng, m, kind: str):
    if kind == "uniform":
        # uniform in (0, 1] as Graph500 SSSP specifies
        return 1.0 - rng.random(m)
    if kind == "bimodal":
        # paper §4.2 weight-variant flavor: two narrow bands (a "short
        # hop" mode near 0.1 and a "long hop" mode near 0.9), stressing
        # the RtoW quantile LUT with a strongly non-uniform distribution
        lo = rng.uniform(0.05, 0.15, m)
        hi = rng.uniform(0.85, 1.0, m)
        return np.where(rng.random(m) < 0.5, lo, hi)
    raise ValueError(f"unknown weight kind {kind}")
