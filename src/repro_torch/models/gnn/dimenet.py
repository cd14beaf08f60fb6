"""DimeNet (Directional Message Passing) — arXiv:2003.03123, the port's
copy of ``repro.models.gnn.dimenet``.

Configuration: n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6.

  * Radial Bessel basis  e_RBF,n(d) = sqrt(2/c) * sin(n pi d / c) / d.
  * Spherical basis      a_SBF,ln(d, alpha) = j_l(z_ln d / c) * Y_l0(alpha)
    with closed-form spherical Bessel functions j_l (l <= 6) and Legendre
    Y_l0; the Bessel roots z_ln are found by host-side bisection
    (:func:`bessel_roots`, the reference's numpy code).
  * Embedding block, interaction blocks with the **bilinear** triplet layer
    out[t, b] = sum_{s,h} sbf[t,s] * x_kj[t,h] * W[b,s,h], and per-block
    output heads summed into the final prediction (paper Fig. 2).

Triplet indices (edge k->j feeding edge j->i, k != i) come from
:func:`repro_torch.data.triplets.build_triplets` with a per-edge cap.

**The basis is the reference's bit for bit.**  The geometry (``vec``,
``dist``, ``cos_t``), :func:`rbf_basis`, :func:`sbf_basis` and
:func:`_sph_jl` repeat XLA:CPU's float32 arithmetic: ``sin``/``cos`` are
:func:`~repro_torch.core.f32math.sinf`/``cosf`` (glibc's, which XLA:CPU
calls), each multiply-add that XLA:CPU contracts into a fused
multiply-add is :func:`~repro_torch.core.f32math.fma`, ``sqrt`` is
:func:`~repro_torch.core.f32math.sqrt` (torch's float32 ``sqrt`` on a
CPU need not round correctly), a division by a constant is a multiply
by its float32 reciprocal (as XLA rewrites it), and every other
division is tensor by tensor (torch on the card multiplies by the
reciprocal of a Python-number divisor, and ``number / tensor`` is a
reciprocal times the number on either device).  On the card the same
ops give the CPU's bits.  The basis matters bit for bit because
:func:`_sph_jl`'s upward recurrence is ill-conditioned for ``x < l``:
it turns a one-ulp difference in ``sin`` into one of order ``10^2`` or
more (ROADMAP.md, queue 3, reference fault 4, which the port
reproduces).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core import f32math
from ..layers import dense_init
from .common import GraphBatch, mlp_apply, mlp_init, run_layer, \
    seg_sum
from ...train.tree import tree_map


# --- closed-form special functions ----------------------------------------

def _div(a, b):
    """``a / b`` in float32 with ``a`` a number or tensor and ``b`` a
    tensor: a true division on every device."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    return a / b


def _recip(c: float) -> float:
    """The float32 ``1 / c`` that XLA multiplies by where the reference
    divides by the constant ``c``."""
    return float(np.float32(1.0) / np.float32(c))


def _sph_jl(l: int, x):
    """Spherical Bessel j_l via upward recurrence (stable for x ~> l);
    the step ``(2l+1)/x * j_l - j_{l-1}`` is one fused multiply-add, as
    XLA:CPU contracts it."""
    x = torch.clamp(x, min=1e-6)
    s = f32math.sinf(x)
    j0 = _div(s, x)
    if l == 0:
        return j0
    j1 = _div(s, x * x) - _div(f32math.cosf(x), x)
    if l == 1:
        return j1
    jm, jc = j0, j1
    for ll in range(1, l):
        jn = f32math.fma(_div(2 * ll + 1, x), jc, -jm)
        jm, jc = jc, jn
    return jc


def _legendre(l: int, x, scale: float = 1.0):
    """``scale * P_l(x)`` by the three-term recurrence; ``scale`` folds
    into the last step's constant divisor as XLA folds it."""
    if l == 0:
        return torch.full_like(x, np.float32(scale))
    if l == 1:
        return x * scale
    pm, pc = torch.ones_like(x), x
    for ll in range(1, l):
        k = _recip(ll + 1)
        if ll == l - 1:
            k = float(np.float32(k) * np.float32(scale))
        pn = f32math.fma((2 * ll + 1) * x, pc, -(ll * pm)) * k
        pm, pc = pc, pn
    return pc


def _y_l0(l: int, cos_theta):
    return _legendre(l, cos_theta, math.sqrt((2 * l + 1) / (4 * math.pi)))


def _bessel_roots(n_spherical: int, n_radial: int) -> np.ndarray:
    """First n_radial positive roots of j_l for l < n_spherical
    (bisection; the reference's numpy code, its recurrence included)."""
    def jl_np(l, x):
        with np.errstate(all="ignore"):
            j0 = np.sin(x) / x
            if l == 0:
                return j0
            j1 = np.sin(x) / x ** 2 - np.cos(x) / x
            if l == 1:
                return j1
            jm, jc = j0, j1
            for ll in range(1, l):
                jm, jc = jc, (2 * ll + 1) / x * jc - jm
            return jc

    roots = np.zeros((n_spherical, n_radial))
    for l in range(n_spherical):
        xs = np.linspace(l + 1e-3, (n_radial + l + 2) * np.pi, 20000)
        ys = jl_np(l, xs)
        sign = np.sign(ys)
        idx = np.where(sign[:-1] * sign[1:] < 0)[0][:n_radial]
        for k, i in enumerate(idx):
            lo, hi = xs[i], xs[i + 1]
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                lo_mid = jl_np(l, np.array([lo]))[0] * \
                    jl_np(l, np.array([mid]))[0]
                if lo_mid <= 0:
                    hi = mid
                else:
                    lo = mid
            roots[l, k] = 0.5 * (lo + hi)
    return roots


_ROOTS_CACHE: dict = {}


def bessel_roots(n_spherical: int, n_radial: int) -> np.ndarray:
    key = (n_spherical, n_radial)
    if key not in _ROOTS_CACHE:
        _ROOTS_CACHE[key] = _bessel_roots(n_spherical, n_radial)
    return _ROOTS_CACHE[key]


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_in: int = 0              # 0 => embed from int node types; else project
    n_types: int = 95
    n_out: int = 1             # regression targets (graph-level)
    graph_level: bool = True
    n_classes: int = 1
    dtype: object = torch.float32
    # process triplets in this many sequential chunks (0/1 = all at once),
    # each under torch.utils.checkpoint: the basis and gathers are
    # recomputed per chunk, bounding the T x (S + D) working set
    triplet_chunks: int = 1
    remat: bool = False


# sin/cos arguments: the radial basis's n*pi*d/c (at most 3.8 d at the
# full configuration) and the spherical basis's z_ln*d/c, where the roots
# stay below (n_radial + n_spherical + 1)*pi (the bisection's grid): at
# most about 8.8 d, far below f32math's 120 for the graphs here (unit
# normal positions; distances below 10)

def rbf_basis(cfg: DimeNetConfig, d):
    """[E] -> [E, n_radial]."""
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32,
                     device=d.device)
    d = torch.clamp(d, min=1e-6)[:, None]
    arg = n * math.pi * d * _recip(cfg.cutoff)
    return _div(math.sqrt(2.0 / cfg.cutoff) * f32math.sinf(arg), d)


def sbf_basis(cfg: DimeNetConfig, d, cos_theta):
    """([T], [T]) -> [T, n_spherical * n_radial]."""
    roots = torch.tensor(bessel_roots(cfg.n_spherical, cfg.n_radial),
                         dtype=torch.float32, device=d.device)
    d = torch.clamp(d, min=1e-6)[:, None]
    outs = []
    for l in range(cfg.n_spherical):
        radial = _sph_jl(l, roots[l][None, :] * d * _recip(cfg.cutoff))
        ang = _y_l0(l, cos_theta)[:, None]
        outs.append(radial * ang)
    return torch.cat(outs, dim=-1)


# The geometry's 3-term sums, in the order and with the contractions that
# XLA:CPU's reductions in the reference's forward use: the squared edge
# length added plainly, the angle's dot product and norms as a chain of
# fused multiply-adds.  XLA vectorises these row reductions and splits
# long ones over threads, and the scalar remainder of a split can take
# the other form: at the Cora shape some lengths and cosines come out an
# ulp apart (none at the tests' sizes).

def _dot(a, b):
    """``sum(a * b, -1)`` over 3 components as one fused chain."""
    return f32math.fma(a[:, 2], b[:, 2],
                       f32math.fma(a[:, 1], b[:, 1], a[:, 0] * b[:, 0]))


def edge_geometry(pos, senders, receivers):
    """``(vec, dist)``: edge j->i's ``x_i - x_j`` and its length (at
    least 1e-6)."""
    vec = pos[receivers] - pos[senders]
    x, y, z = vec[:, 0], vec[:, 1], vec[:, 2]
    sq = (x * x + y * y) + z * z
    return vec, f32math.sqrt(torch.clamp(sq, min=1e-12))


def triplet_cos(pos, vec, senders, receivers, kj, ji):
    """The angle's cosine between edge ji and edge kj (as ``x_k - x_j``),
    clipped to [-1, 1]."""
    v_ji = vec[ji]
    v_kj = pos[senders[kj]] - pos[receivers[kj]]
    norm = f32math.sqrt(_dot(v_ji, v_ji)) * f32math.sqrt(_dot(v_kj, v_kj))
    return torch.clamp(_div(_dot(v_ji, v_kj), torch.clamp(norm, min=1e-9)),
                       -1.0, 1.0)


def init_params(cfg: DimeNetConfig, gen: torch.Generator):
    """``{"embed", "rbf_lin", "edge_mlp", "blocks": {w_kj, w_ji, sbf_lin,
    bilinear, w_bil_out, mlp, rbf_out, out_mlp} stacked over the blocks,
    "out_final"}``, drawn on ``gen``'s device."""
    d, dev, lead = cfg.d_hidden, gen.device, (cfg.n_blocks,)
    n_sbf = cfg.n_spherical * cfg.n_radial
    if cfg.d_in:
        embed = dense_init(gen, cfg.d_in, d, cfg.dtype)
    else:
        embed = (torch.randn((cfg.n_types, d), generator=gen, device=dev)
                 * 0.02).to(cfg.dtype)
    bil = torch.randn((*lead, cfg.n_bilinear, n_sbf, d), generator=gen,
                      device=dev) / math.sqrt(d)
    blocks = {
        "w_kj": dense_init(gen, d, d, cfg.dtype, lead=lead),
        "w_ji": dense_init(gen, d, d, cfg.dtype, lead=lead),
        "sbf_lin": dense_init(gen, n_sbf, n_sbf, cfg.dtype, lead=lead),
        "bilinear": bil.to(cfg.dtype),
        "w_bil_out": dense_init(gen, cfg.n_bilinear, d, cfg.dtype,
                                lead=lead),
        "mlp": mlp_init(gen, [d, d], cfg.dtype, lead=lead),
        "rbf_out": dense_init(gen, cfg.n_radial, d, cfg.dtype, lead=lead),
        "out_mlp": mlp_init(gen, [d, d], cfg.dtype, lead=lead),
    }
    return {
        "embed": embed,
        "rbf_lin": dense_init(gen, cfg.n_radial, d, cfg.dtype),
        "edge_mlp": mlp_init(gen, [3 * d, d], cfg.dtype),
        "blocks": blocks,
        "out_final": mlp_init(gen, [d, d, cfg.n_out], cfg.dtype),
    }


def bilinear(sbf_p, x_kj_t, w):
    """``einsum("ts,td,bsd->tb", sbf_p, x_kj_t, w)`` in two steps:
    ``x_kj_t @ w`` as a ``[D, B*S]`` matrix gives ``[T, B, S]``, then the
    product with ``sbf_p`` summed over S.  A left-to-right contraction
    would make a ``[T, S, D]`` temporary (3.6 GB at the Cora shape)."""
    b, s, d = w.shape
    xw = (x_kj_t @ w.permute(2, 0, 1).reshape(d, b * s)).view(-1, b, s)
    return (xw * sbf_p[:, None, :]).sum(-1)


def forward(cfg: DimeNetConfig, params, gb: GraphBatch):
    """Graph regression (or node output if graph_level=False)."""
    n = gb.node_feat.shape[0] if gb.node_feat is not None else \
        gb.pos.shape[0]
    pos = gb.pos.to(torch.float32)
    snd, rcv = gb.senders, gb.receivers
    vec, dist = edge_geometry(pos, snd, rcv)
    rbf = rbf_basis(cfg, dist)                               # [E, R]

    if cfg.d_in:
        h = gb.node_feat.to(cfg.dtype) @ params["embed"]
    else:
        h = params["embed"].index_select(
            0, gb.node_feat.to(torch.int64).reshape(-1))
    rbf_h = rbf @ params["rbf_lin"]
    m = mlp_apply(params["edge_mlp"],
                  torch.cat([h.index_select(0, snd), h.index_select(0, rcv),
                             rbf_h], -1),
                  act=F.silu, final_act=True)                # [E, D]

    t_kj, t_ji, t_mask = gb.triplet_kj, gb.triplet_ji, gb.triplet_mask
    e_count = snd.shape[0]

    def tri_sbf(kj, ji, msk):
        sbf = sbf_basis(cfg, dist[kj],
                        triplet_cos(pos, vec, snd, rcv, kj, ji))  # [Tc, S]
        if msk is not None:
            sbf = torch.where(msk[:, None], sbf, 0.0)
        return sbf

    def tri_part(bp, x_kj, kj, ji, msk):
        # gathers of trained tensors by index_select: its backward is an
        # index_add, where a fancy index's is a sorted accumulate (112 of
        # a step's 223 device ms at the Cora shape on an H100)
        sbf_p = tri_sbf(kj, ji, msk) @ bp["sbf_lin"]
        return seg_sum(bilinear(sbf_p, x_kj.index_select(0, kj),
                                bp["bilinear"]), ji,
                       e_count)

    def tri_aggregate(bp, x_kj):
        """Sum over triplets of the bilinear interaction -> [E, B]; in
        ``triplet_chunks`` chunks added in order, each rematerialised."""
        nch = max(cfg.triplet_chunks, 1)
        t_total = t_kj.shape[0]
        if nch <= 1 or t_total % nch != 0:
            return tri_part(bp, x_kj, t_kj, t_ji, t_mask)
        tc = t_total // nch
        mk = t_mask if t_mask is not None else torch.ones(
            t_total, dtype=torch.bool, device=t_kj.device)
        acc = torch.zeros((e_count, cfg.n_bilinear), dtype=torch.float32,
                          device=m.device)
        for c in range(nch):
            sl = slice(c * tc, (c + 1) * tc)
            acc = acc + run_layer(tri_part, True, bp, x_kj, t_kj[sl],
                                  t_ji[sl], mk[sl])
        return acc

    def block(m, out_acc, bp):
        x_kj = F.silu(m @ bp["w_kj"])
        x_ji = F.silu(m @ bp["w_ji"])
        agg = tri_aggregate(bp, x_kj)                        # [E, B]
        m_new = x_ji + agg @ bp["w_bil_out"]
        m = m + mlp_apply(bp["mlp"], m_new, act=F.silu, final_act=True)
        node_contrib = seg_sum((rbf @ bp["rbf_out"]) * m, rcv, n)
        out_acc = out_acc + mlp_apply(bp["out_mlp"], node_contrib,
                                      act=F.silu, final_act=True)
        return m, out_acc

    out_acc = torch.zeros((n, cfg.d_hidden), dtype=torch.float32,
                          device=m.device)
    for i in range(cfg.n_blocks):
        m, out_acc = run_layer(block, cfg.remat, m, out_acc,
                               tree_map(lambda t: t[i], params["blocks"]))

    node_out = mlp_apply(params["out_final"], out_acc, act=F.silu)
    if cfg.graph_level:
        return seg_sum(node_out, gb.graph_ids, gb.n_graphs)
    return node_out
