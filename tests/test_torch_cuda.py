"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA GPU:

    python -m pytest -q tests/test_torch_cuda.py

This file imports neither jax nor the reference package (the machine
with the card has no jax): its inputs come from the port's own builders
and numpy.  Every test needs the card and skips without one; the kernels
build with nvcc on first use.  The edge-relax comparisons are bitwise;
flash attention is held to its plain version (f32 inside) at 2e-5 in
float32 and 2e-2 in bfloat16, the tolerances of the reference's own
kernel tests, and each of its designs ("tc", "split", "simt") is checked
to serve the calls that ``ops.variant`` gives it.  embedding_bag is held
bitwise against its plain version (both sum in lookup order with
separately rounded multiplies and adds), and the recsys layer on the
card bitwise against the same call on the CPU.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import (shard_blocked, shard_graph,
                                          sssp_distributed)
from repro_torch.core.graph import TileIndex, build_blocked, build_csr
from repro_torch.core.landmarks import build_landmarks
from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict, sssp
from repro_torch.data.generators import kronecker, road_grid
from repro_torch.kernels.edge_relax import ops, ref
from repro_torch.kernels.embedding_bag import ops as eops
from repro_torch.kernels.flash_attn import ops as fops
from repro_torch.models.recsys import embedding as remb
from repro_torch.models.transformer import ring_positions
from repro_torch.serve.queries import reconstruct_path

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _graph(rng, *, ties):
    n, m = 900, 5000
    u = rng.integers(0, n // 2, m)
    v = rng.integers(0, n, m)
    keep = u != v
    w = (rng.integers(1, 4, keep.sum()).astype(np.float64) if ties
         else rng.random(keep.sum()) + 1e-3)
    return build_csr(n, u[keep], v[keep], w)


def _f32(x, device):
    return torch.full((), x, dtype=torch.float32, device=device)


def test_cuda_kernel_matches_plain_version(card):
    rng = np.random.default_rng(5)
    bg = build_blocked(_graph(rng, ties=True), block_v=256, tile_e=64,
                       device=card)
    dist = rng.integers(0, 5, bg.n_out).astype(np.float32)
    dist[rng.random(bg.n_out) < 0.2] = np.inf
    front = (rng.random(bg.n_out) < 0.3) & np.isfinite(dist)
    parent = np.where(np.isfinite(dist), rng.integers(0, bg.n_out,
                                                      bg.n_out), -1)
    t = lambda a: torch.from_numpy(a).to(card)
    args = (t(dist), t(front), t(parent.astype(np.int32)), bg.src, bg.dst,
            bg.w, bg.tile_first, _f32(0.0, card), _f32(np.inf, card))
    kw = dict(tile_e=bg.tile_e, n_out=bg.n_out)
    before = ops.LAUNCHES.edge_relax
    vals, wins, cnt = ops.relax_bucket(*args, index=bg.index, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES.edge_relax == before + 1
    pv, pw, pc = ref.edge_relax_partials_ref(*args, **kw)
    _, pn = ref.schedule_tiles(args[1], args[3], args[5], args[6],
                               kw["tile_e"])
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(wins, pw) and int(cnt[2]) == int(pn)
    assert cnt.tolist() == pc.tolist()


def test_cuda_fused_kernel_matches_plain_version(card):
    for ties in (True, False):
        rng = np.random.default_rng(5)
        bg = build_blocked(_graph(rng, ties=ties), block_v=256, tile_e=64,
                           device=card)
        n = 900
        dist = rng.integers(0, 5, bg.n_out).astype(np.float32)
        dist[rng.random(bg.n_out) < 0.5] = np.inf
        dist[n:] = np.inf
        parent = np.where(np.isfinite(dist), rng.integers(0, n, bg.n_out),
                          -1).astype(np.int32)
        front = (rng.random(bg.n_out) < 0.3) & np.isfinite(dist)
        t = lambda a: torch.from_numpy(a).to(card)
        args = (t(dist), t(parent), t(front), bg.deg, bg.src, bg.dst, bg.w,
                bg.tile_first, _f32(1.0, card), _f32(6.0, card))
        kw = dict(tile_e=bg.tile_e, fused_rounds=4)
        before = ops.LAUNCHES.edge_relax_fused
        out = ops.relax_fused(*args, **kw, index=bg.index)
        torch.cuda.synchronize()
        assert ops.LAUNCHES.edge_relax_fused == before + 1
        want = ref.edge_relax_fused_ref(*args, **kw)
        assert torch.equal(out[0].view(torch.int32),
                           want[0].view(torch.int32))
        for a, b in zip(out[1:], want[1:]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
@pytest.mark.parametrize("window", [(0.0, np.inf), (1.0, 4.0)],
                         ids=["lb0", "mid"])
def test_cuda_partials_kernel_matches_plain_version(card, ties, window):
    # a P = 4 layout: each shard's sources are a local range of its own,
    # its destinations the global range, so a confusion of the two id
    # spaces shows here and not at P = 1
    rng = np.random.default_rng(7)
    g = _graph(rng, ties=ties)
    arrays, meta = shard_blocked(g, 4, block_v=75, tile_e=64)
    block = meta.n_src_blocks * meta.block_v
    assert meta.n_src_blocks > 1 and meta.n_dst_blocks == 4 * 3
    n_pad, n_out = 4 * block, meta.n_dst_blocks * meta.block_v
    dist = (rng.integers(0, 6, n_pad) if ties
            else rng.random(n_pad) * 3).astype(np.float32)
    dist[rng.random(n_pad) < 0.2] = np.inf
    paths = (rng.random(n_pad) < 0.4) & np.isfinite(dist)
    parent = np.where(np.isfinite(dist), rng.integers(0, n_pad, n_pad),
                      -1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    lb, ub = _f32(window[0], card), _f32(window[1], card)
    kw = dict(tile_e=meta.tile_e, n_out=n_out)
    trav = 0
    for q in range(4):
        lo = q * block
        args = (t(dist[lo:lo + block]), t(paths[lo:lo + block]),
                t(parent[lo:lo + block]), t(arrays.src[q]), t(arrays.dst[q]),
                t(arrays.w[q]), t(arrays.tile_first[q]))
        before = ops.LAUNCHES.edge_relax_partials
        val, win, cnt = ops.relax_partials(*args, lb, ub, **kw,
                                           index=_shard_index(arrays, q,
                                                              card))
        torch.cuda.synchronize()
        assert ops.LAUNCHES.edge_relax_partials == before + 1
        pv, pw, pc = ref.edge_relax_partials_ref(*args, lb, ub, **kw)
        assert torch.equal(val.view(torch.int32), pv.view(torch.int32)), q
        assert torch.equal(win, pw), q
        assert cnt.tolist() == pc.tolist(), q
        assert int(cnt[3]) == 0
        trav += int(cnt[0])
    assert trav > 0


def _shard_index(arrays, q, card):
    """Shard ``q``'s TileIndex of a stacked shard layout, on the card."""
    return TileIndex(arrays.vt_ptr[q], arrays.vt_tile[q],
                     arrays.forced[q]).to(card)


def _alt_lb(rng, n_out, n, card):
    lb = (rng.integers(0, 8, n_out) / 4).astype(np.float32)
    lb[(rng.random(n_out) < 0.15) | (np.arange(n_out) >= n)] = np.inf
    return torch.from_numpy(lb).to(card)


@pytest.mark.parametrize("bound", [2.0, np.inf, 0.0, 3.0],
                         ids=["mid", "inf", "below-all", "ties"])
def test_cuda_partials_alt_kernel_matches_plain_version(card, bound):
    # the P = 4 layout of the non-ALT test, integer dists, weights and
    # bounds (ties at exactly the bound, which `<=` keeps)
    rng = np.random.default_rng(10)
    g = _graph(rng, ties=True)
    arrays, meta = shard_blocked(g, 4, block_v=75, tile_e=64)
    block = meta.n_src_blocks * meta.block_v
    n_pad, n_out = 4 * block, meta.n_dst_blocks * meta.block_v
    dist = rng.integers(0, 5, n_pad).astype(np.float32)
    dist[rng.random(n_pad) < 0.2] = np.inf
    paths = (rng.random(n_pad) < 0.4) & np.isfinite(dist)
    parent = np.where(np.isfinite(dist), rng.integers(0, n_pad, n_pad),
                      -1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    lb, ub = _f32(1.0, card), _f32(6.0, card)
    alt = (_alt_lb(rng, n_out, g.n, card), _f32(bound, card))
    kw = dict(tile_e=meta.tile_e, n_out=n_out)
    kept = pruned = 0
    for q in range(4):
        lo = q * block
        args = (t(dist[lo:lo + block]), t(paths[lo:lo + block]),
                t(parent[lo:lo + block]), t(arrays.src[q]), t(arrays.dst[q]),
                t(arrays.w[q]), t(arrays.tile_first[q]), lb, ub)
        pv, pw, pc = ref.edge_relax_partials_ref(*args, *alt, **kw)
        index = _shard_index(arrays, q, card)
        for _ in range(2):
            before = (ops.LAUNCHES.edge_relax_partials,
                      ops.LAUNCHES.edge_relax_partials_alt)
            val, win, cnt = ops.relax_partials(*args, *alt, **kw,
                                               index=index)
            torch.cuda.synchronize()
            assert (ops.LAUNCHES.edge_relax_partials,
                    ops.LAUNCHES.edge_relax_partials_alt) == \
                (before[0], before[1] + 1)
            assert torch.equal(val.view(torch.int32),
                               pv.view(torch.int32)), q
            assert torch.equal(win, pw), q
            assert cnt.tolist() == pc.tolist(), q
        free = ops.relax_partials(*args, **kw, index=index)[2].tolist()
        trav, rlx, tiles, prn = cnt.tolist()
        assert [trav, rlx + prn, tiles, 0] == free, q
        kept, pruned = kept + rlx, pruned + prn
    if bound == 0.0:
        assert kept == 0 and pruned > 0
    elif bound == np.inf:
        assert pruned == 0 and kept > 0
    else:
        assert kept > 0 and pruned > 0


@pytest.mark.parametrize("bound", [2.0, np.inf, 0.0, 3.0],
                         ids=["mid", "inf", "below-all", "ties"])
def test_cuda_alt_kernel_matches_plain_version(card, bound):
    # integer weights, dists and bounds: many candidates land exactly on
    # the bound, which `<=` keeps
    rng = np.random.default_rng(8)
    bg = build_blocked(_graph(rng, ties=True), block_v=256, tile_e=64,
                       device=card)
    dist = rng.integers(0, 5, bg.n_out).astype(np.float32)
    dist[rng.random(bg.n_out) < 0.2] = np.inf
    front = (rng.random(bg.n_out) < 0.3) & np.isfinite(dist)
    parent = np.where(np.isfinite(dist), rng.integers(0, bg.n_out,
                                                      bg.n_out), -1)
    t = lambda a: torch.from_numpy(a).to(card)
    args = (t(dist), t(front), t(parent.astype(np.int32)), bg.src, bg.dst,
            bg.w, bg.tile_first, _f32(0.0, card), _f32(6.0, card),
            _alt_lb(rng, bg.n_out, 900, card), _f32(bound, card))
    kw = dict(tile_e=bg.tile_e, n_out=bg.n_out)
    before = (ops.LAUNCHES.edge_relax, ops.LAUNCHES.edge_relax_alt)
    vals, wins, cnt = ops.relax_bucket(*args, index=bg.index, **kw)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES.edge_relax,
            ops.LAUNCHES.edge_relax_alt) == (before[0], before[1] + 1)
    pv, pw, pc = ref.edge_relax_partials_ref(*args, **kw)
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(wins, pw) and cnt.tolist() == pc.tolist()
    if bound == 0.0:
        assert not torch.isfinite(vals).any()
    else:
        assert torch.isfinite(vals).any()


# ---------------------------------------------------------------------------
# edge_relax and edge_relax_partials: the frontier-driven schedule
# ---------------------------------------------------------------------------

# chip_smoke.py's ALT_BOUNDS: a bound between the candidates, +inf, below
# every candidate, and one that integer sums meet exactly
ALT_BOUNDS = (("mid", 2.0), ("inf", np.inf), ("below-all", 0.0),
              ("ties", 3.0))


def _state(rng, bg, n_front, card, *, lb=1.0, ub=6.0):
    """Integer dists on the real vertices (+inf on a fifth and on the
    padding), ``n_front`` path sources among the reached ones (all of
    them for -1), random parents, and the window [lb, ub)."""
    n, n_out = bg.n, bg.n_out
    dist = rng.integers(0, 5, n_out).astype(np.float32)
    dist[(rng.random(n_out) < 0.2) | (np.arange(n_out) >= n)] = np.inf
    reached = np.flatnonzero(np.isfinite(dist))
    paths = np.zeros(n_out, bool)
    pick = reached if n_front < 0 else rng.choice(
        reached, min(n_front, reached.size), replace=False)
    paths[pick] = True
    parent = np.where(np.isfinite(dist), rng.integers(0, n, n_out),
                      -1).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(card)
    return (t(dist), t(paths), t(parent), _f32(lb, card), _f32(ub, card))


def _check_round(bg, state, alt=(), what=""):
    """Both one-round kernels, each called twice, against the plain
    version on one layout: vals, wins, the scheduled-tile count and the
    counters bitwise; the cached scratch left clean.  Returns the plain
    version's counters."""
    dist, paths, parent, lb, ub = state
    args = (dist, paths, parent, bg.src, bg.dst, bg.w, bg.tile_first, lb,
            ub, *alt)
    kw = dict(tile_e=bg.tile_e, n_out=bg.n_out)
    pv, pw, pc = ref.edge_relax_partials_ref(*args, **kw)
    _, pn = ref.schedule_tiles(paths, bg.src, bg.w, bg.tile_first,
                               bg.tile_e)
    assert int(pc[2]) == int(pn), what
    for name, fn in (("edge_relax", ops.relax_bucket),
                     ("edge_relax_partials", ops.relax_partials)):
        counter = name + ("_alt" if alt else "")
        for _ in range(2):
            before = getattr(ops.LAUNCHES, counter)
            val, win, cnt = fn(*args, index=bg.index, **kw)
            torch.cuda.synchronize()
            assert getattr(ops.LAUNCHES, counter) == before + 1
            assert torch.equal(val.view(torch.int32),
                               pv.view(torch.int32)), (what, name)
            assert torch.equal(win, pw), (what, name)
            assert cnt.tolist() == pc.tolist(), (what, name)
    for flags, _, keys in ops._SCRATCH.values():
        assert not bool(flags.any()), what
        assert bool((keys == ref.EMPTY_KEY).all()), what
    return pc.tolist()


def _star(n, rng, *, inf_frac=0.0):
    """Vertex 0 joined to every other vertex both ways, plus a sparse
    random graph: vertex 0's slots span many tiles."""
    u = rng.integers(0, n, 2 * n)
    v = rng.integers(0, n, 2 * n)
    keep = u != v
    src = np.concatenate([np.zeros(n - 1, np.int64), u[keep]])
    dst = np.concatenate([np.arange(1, n), v[keep]])
    w = rng.integers(1, 4, src.size).astype(np.float64)
    w[rng.random(w.size) < inf_frac] = np.inf
    return build_csr(n, src, dst, w)


def test_cuda_frontier_schedule_road(card):
    rng = np.random.default_rng(21)
    bg = build_blocked(road_grid(64, seed=3), device=card)
    assert bg.n_blocks == 1 and bg.tile_e == 256       # the card's layout
    for n_front in (3, 40, -1):
        counts = _check_round(bg, _state(rng, bg, n_front, card),
                              what=f"road frontier {n_front}")
        assert counts[2] < bg.tile_first.shape[0] or n_front < 0


def test_cuda_frontier_schedule_empty_frontier(card):
    rng = np.random.default_rng(22)
    for block_v, tile_e in ((None, None), (64, 64)):
        bg = build_blocked(road_grid(40, seed=4), block_v=block_v,
                           tile_e=tile_e, device=card)
        counts = _check_round(bg, _state(rng, bg, 0, card),
                              what=f"empty frontier {block_v}")
        assert counts == [0, 0, int(bg.tile_first.sum()), 0]


@pytest.mark.parametrize("inf_frac", [0.0, 0.2], ids=["finite", "inf"])
def test_cuda_frontier_schedule_hub(card, inf_frac):
    rng = np.random.default_rng(23)
    g = _star(40000, rng, inf_frac=inf_frac)
    for block_v, tile_e in ((None, None), (1024, 256)):
        bg = build_blocked(g, block_v=block_v, tile_e=tile_e, device=card)
        ptr = bg.index.vt_ptr
        assert int(ptr[1] - ptr[0]) > 100          # the hub's tiles
        state = _state(rng, bg, 200, card)
        state[1][0] = True                         # the hub on a path
        state[0][0] = 0.0
        _check_round(bg, state, what=f"hub {block_v} inf {inf_frac}")


def test_cuda_frontier_schedule_inf_weights_multi_bucket(card):
    rng = np.random.default_rng(24)
    g = _graph(rng, ties=True)
    n = g.n
    w = g.w.copy()
    w[rng.random(w.size) < 0.25] = np.inf
    g = build_csr(n, g.src, g.dst, w, symmetrize=False)
    for block_v, tile_e in ((64, 32), (256, 64), (1024, 256),
                            (None, None)):
        bg = build_blocked(g, block_v=block_v, tile_e=tile_e, device=card)
        for n_front in (5, -1):
            _check_round(bg, _state(rng, bg, n_front, card, lb=0.0,
                                    ub=np.inf),
                         what=f"inf weights {block_v}/{tile_e}")


@pytest.mark.parametrize("bound", [b for _, b in ALT_BOUNDS],
                         ids=[k for k, _ in ALT_BOUNDS])
def test_cuda_frontier_schedule_alt(card, bound):
    rng = np.random.default_rng(25)
    for block_v, tile_e in ((None, None), (256, 64)):
        bg = build_blocked(_graph(rng, ties=True), block_v=block_v,
                           tile_e=tile_e, device=card)
        alt = (_alt_lb(rng, bg.n_out, bg.n, card), _f32(bound, card))
        trav, rlx, _, prn = _check_round(
            bg, _state(rng, bg, -1, card), alt,
            what=f"alt {bound} {block_v}")
        if bound == 0.0:
            assert rlx == 0 and prn > 0
        elif bound == np.inf:
            assert prn == 0 and rlx > 0


def test_cuda_frontier_schedule_layouts_in_turn(card):
    # A, B (the sizes of A: the same cached scratch), C (other sizes),
    # then A again: a flag or key left set by one call shows in the next
    rng = np.random.default_rng(26)
    ga = _graph(rng, ties=True)
    a = build_blocked(ga, block_v=256, tile_e=64, device=card)
    c = build_blocked(road_grid(48, seed=6), device=card)
    sa = _state(rng, a, -1, card)
    sb = _state(rng, a, 7, card, lb=0.0, ub=np.inf)
    sc = _state(rng, c, 30, card)
    first = _check_round(a, sa, what="A")
    _check_round(a, sb, what="B")
    _check_round(c, sc, what="C")
    assert _check_round(a, sa, what="A again") == first


@pytest.mark.parametrize("case", ["mid", "inf", "below-all", "tightens"])
def test_cuda_fused_alt_kernel_matches_plain_version(card, case):
    rng = np.random.default_rng(9)
    bg = build_blocked(_graph(rng, ties=case != "tightens"), block_v=256,
                       tile_e=64, device=card)
    n = 900
    dist = rng.integers(0, 5, bg.n_out).astype(np.float32)
    dist[rng.random(bg.n_out) < 0.5] = np.inf
    dist[n:] = np.inf
    parent = np.where(np.isfinite(dist), rng.integers(0, n, bg.n_out),
                      -1).astype(np.int32)
    front = (rng.random(bg.n_out) < 0.3) & np.isfinite(dist)
    # the tightening target is unreached at the start of the call
    tgt = int(np.where(np.isinf(dist[:n]) if case == "tightens"
                       else np.isfinite(dist[:n]))[0][3])
    prune_ub = {"mid": 4.0, "inf": np.inf, "below-all": 0.0,
                "tightens": np.inf}[case]
    t = lambda a: torch.from_numpy(a).to(card)
    args = (t(dist), t(parent), t(front), bg.deg, bg.src, bg.dst, bg.w,
            bg.tile_first, _f32(1.0, card), _f32(12.0, card),
            _alt_lb(rng, bg.n_out, n, card), _f32(prune_ub, card),
            _f32(1.0 + 4.0 * 2.0 ** -24 * 100, card),
            torch.tensor(tgt, dtype=torch.int32, device=card))
    kw = dict(tile_e=bg.tile_e, fused_rounds=6)
    want = ref.edge_relax_fused_ref(*args, **kw)
    for _ in range(2):
        before = ops.LAUNCHES.edge_relax_fused_alt
        out = ops.relax_fused(*args, **kw, index=bg.index)
        torch.cuda.synchronize()
        assert ops.LAUNCHES.edge_relax_fused_alt == before + 1
        assert torch.equal(out[0].view(torch.int32),
                           want[0].view(torch.int32))
        for a, b in zip(out[1:], want[1:]):
            assert torch.equal(a, b)
    cnt = dict(zip(ops.FUSED_COUNTERS, out[3].tolist()))
    if case == "below-all":
        assert cnt["n_relax"] == 0 and cnt["n_pruned"] > 0
    if case == "tightens":
        assert torch.isfinite(out[0][tgt]) and cnt["n_exec"] > 1


# ---------------------------------------------------------------------------
# edge_relax_fused: frontier lists, the index schedule, cached scratch
# ---------------------------------------------------------------------------

def _fused_alt(rng, bg, card, prune_ub=np.inf, tgt=None):
    """ALT operands for a fused call: ``_alt_lb``'s quarters, the prune
    bound, chip_smoke.py's inflation and the target (by default a random
    one, reached or not, so that the bound may tighten within the
    call)."""
    tgt = int(rng.integers(0, bg.n)) if tgt is None else tgt
    return (_alt_lb(rng, bg.n_out, bg.n, card), _f32(prune_ub, card),
            _f32(1.0 + 4.0 * 2.0 ** -24 * 100, card),
            torch.tensor(tgt, dtype=torch.int32, device=card))


def _assert_fused_scratch_clean(what=""):
    for s in ops._FUSED_SCRATCH.values():
        assert bool((s.keys == ref.EMPTY_KEY).all()), what
        assert not bool(s.flags.any()), what
        assert not bool(s.marks.any()), what
        assert not bool(s.scal.any()), what


def _check_fused(bg, state, alt=(), *, rounds=4, what=""):
    """``relax_fused``, called twice, against the plain version and the
    kernel's steps written plainly on one layout: dist, parent, frontier
    and the eight counters bitwise, the launch counted, the cached
    scratch left clean.  Returns the counters by name."""
    dist, front, parent, lb, ub = state
    args = (dist, parent, front, bg.deg, bg.src, bg.dst, bg.w,
            bg.tile_first, lb, ub, *alt)
    kw = dict(tile_e=bg.tile_e, fused_rounds=rounds)
    want = ref.edge_relax_fused_ref(*args, **kw)
    steps = ref.edge_relax_fused_steps(*args, **kw, index=bg.index)
    counter = "edge_relax_fused" + ("_alt" if alt else "")
    for _ in range(2):
        before = getattr(ops.LAUNCHES, counter)
        out = ops.relax_fused(*args, **kw, index=bg.index)
        torch.cuda.synchronize()
        assert getattr(ops.LAUNCHES, counter) == before + 1, what
        for plain in (want, steps):
            assert torch.equal(out[0].view(torch.int32),
                               plain[0].view(torch.int32)), what
            for a, b in zip(out[1:], plain[1:]):
                assert torch.equal(a, b), what
        _assert_fused_scratch_clean(what)
    return dict(zip(ops.FUSED_COUNTERS, out[3].tolist()))


@pytest.mark.parametrize("alt", [False, True], ids=["plain", "alt"])
@pytest.mark.parametrize("n_front", [0, 3, 40, -1, "every"])
def test_cuda_fused_frontier_sizes(card, n_front, alt):
    # the card's one-bucket road layout and a multi-bucket one with +inf
    # edges; rounds 1, 4, 8 and a window with lb <= 0 (one round)
    rng = np.random.default_rng(27)
    g = _graph(rng, ties=True)
    w = g.w.copy()
    w[rng.random(w.size) < 0.1] = np.inf
    layouts = (build_blocked(road_grid(64, seed=3), device=card),
               build_blocked(build_csr(g.n, g.src, g.dst, w,
                                       symmetrize=False), block_v=64,
                             tile_e=32, device=card))
    for bg in layouts:
        for rounds, lb in ((1, 1.0), (4, 1.0), (8, 1.0), (4, 0.0)):
            dist, front, parent, lbt, ub = _state(
                rng, bg, 0 if n_front == "every" else n_front, card, lb=lb,
                ub=9.0)
            if n_front == "every":
                front = torch.ones_like(front)
            extra = _fused_alt(rng, bg, card, 6.0) if alt else ()
            cnt = _check_fused(bg, (dist, front, parent, lbt, ub), extra,
                               rounds=rounds,
                               what=f"{n_front} {bg.tile_e} {rounds} {lb}")
            assert 1 <= cnt["n_exec"] <= (1 if lb <= 0 else rounds)
            assert cnt["n_rounds"] == (0 if n_front == 0 else
                                       cnt["n_exec"])
            if n_front == 0:
                forced = int(bg.tile_first.sum())
                assert [cnt[k] for k in ("n_trav", "n_tiles", "n_exec")] \
                    == [0, forced, 1]


def test_cuda_fused_vertex_improves_in_consecutive_rounds(card):
    # a -> v (5), b -> c (1), c -> v (1): v improves in round 0 (via a)
    # and again in round 1 (via c), while it is on round 1's frontier
    rng = np.random.default_rng(28)
    n = 400
    u = rng.integers(4, n, 1500)
    x = rng.integers(4, n, 1500)
    keep = u != x
    src = np.concatenate([[0, 1, 2], u[keep]])
    dst = np.concatenate([[3, 2, 3], x[keep]])
    w = np.concatenate([[5.0, 1.0, 1.0], rng.integers(1, 4, keep.sum())])
    bg = build_blocked(build_csr(n, src, dst, w), block_v=64, tile_e=32,
                       device=card)
    dist = np.full(bg.n_out, np.inf, np.float32)
    dist[[0, 1]] = 0.0               # sources of degree 1: on a path
    front = np.zeros(bg.n_out, bool)
    front[[0, 1]] = True
    parent = np.full(bg.n_out, -1, np.int32)
    t = lambda a: torch.from_numpy(a).to(card)
    state = (t(dist), t(front), t(parent), _f32(0.5, card),
             _f32(10.0, card))
    one = ops.relax_fused(state[0], state[2], state[1], bg.deg, bg.src,
                          bg.dst, bg.w, bg.tile_first, *state[3:],
                          tile_e=bg.tile_e, fused_rounds=1, index=bg.index)
    assert float(one[0][3]) == 5.0 and bool(one[2][3])
    cnt = _check_fused(bg, state, rounds=4, what="twice")
    out = ops.relax_fused(state[0], state[2], state[1], bg.deg, bg.src,
                          bg.dst, bg.w, bg.tile_first, *state[3:],
                          tile_e=bg.tile_e, fused_rounds=4, index=bg.index)
    assert float(out[0][3]) == 2.0 and int(out[1][3]) == 2
    assert cnt["n_exec"] == 3 and cnt["n_updates"] == 3


def test_cuda_fused_scratch_clean_over_layouts_in_turn(card):
    # A, B (other sizes), A again, both branches: a key, flag, mark or
    # round scalar left set by one call shows in the next
    rng = np.random.default_rng(29)
    a = build_blocked(_graph(rng, ties=True), block_v=256, tile_e=64,
                      device=card)
    b = build_blocked(road_grid(48, seed=6), device=card)
    sa = _state(rng, a, -1, card)
    first = _check_fused(a, sa, what="A")
    _check_fused(b, _state(rng, b, 30, card), what="B")
    _check_fused(a, _state(rng, a, 7, card), _fused_alt(rng, a, card, 5.0),
                 what="A alt")
    _check_fused(b, _state(rng, b, -1, card), _fused_alt(rng, b, card),
                 what="B alt")
    assert _check_fused(a, sa, what="A again") == first


@pytest.mark.parametrize("alt", [False, True], ids=["plain", "alt"])
def test_cuda_fused_graph_replay_matches_eager(card, alt):
    # one eager call makes the scratch; a captured call then replays
    # bitwise equal to it, and leaves the scratch clean
    rng = np.random.default_rng(30)
    bg = build_blocked(road_grid(64, seed=3), device=card)
    dist, front, parent, lb, ub = _state(rng, bg, 200, card, ub=4.0)
    # an unreached target and a bound above every candidate: the call
    # runs several rounds with ALT too
    far = int(torch.nonzero(torch.isinf(dist[:bg.n]))[0])
    extra = _fused_alt(rng, bg, card, 9.0, far) if alt else ()
    call = lambda: ops.relax_fused(
        dist, parent, front, bg.deg, bg.src, bg.dst, bg.w, bg.tile_first,
        lb, ub, *extra, tile_e=bg.tile_e, fused_rounds=4, index=bg.index)
    eager = call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed[0].view(torch.int32),
                           eager[0].view(torch.int32))
        for x, y in zip(replayed[1:], eager[1:]):
            assert torch.equal(x, y)
        _assert_fused_scratch_clean("replay")
    assert eager[3][ops.FUSED_COUNTERS.index("n_exec")] > 1


def test_cuda_fused_needs_the_index(card):
    rng = np.random.default_rng(31)
    bg = build_blocked(road_grid(16, seed=3), device=card)
    dist, front, parent, lb, ub = _state(rng, bg, 10, card)
    with pytest.raises(ValueError, match="TileIndex"):
        ops.relax_fused(dist, parent, front, bg.deg, bg.src, bg.dst, bg.w,
                        bg.tile_first, lb, ub, tile_e=bg.tile_e,
                        fused_rounds=4)


def test_cuda_alt_p2p_matches_segment_min(card):
    for g, seed in ((kronecker(10, 8, seed=1), 3), (road_grid(24, seed=2),
                                                     4)):
        lm = build_landmarks(g, 4, device=card)
        rng = np.random.default_rng(seed)
        s, t = (int(v) for v in rng.choice(g.n, 2, replace=False))
        kw = dict(goal="p2p", goal_param=t, device=card)
        plain = sssp(g, s, backend="segment_min", **kw)
        want = sssp(g, s, backend="segment_min", landmarks=lm, **kw)
        path = reconstruct_path(plain[1].cpu().numpy(), s, t)
        for opts, counter in ((dict(), "edge_relax_alt"),
                              (dict(fused_rounds=4), "edge_relax_fused_alt")):
            before = getattr(ops.LAUNCHES, counter)
            d, p, m = sssp(g, s, backend="blocked", landmarks=lm, **kw,
                           **opts)
            assert getattr(ops.LAUNCHES, counter) > before, counter
            assert torch.equal(d.view(torch.int32),
                               want[0].view(torch.int32)), opts
            assert torch.equal(p, want[1]), opts
            md, wd = metrics_dict(m), metrics_dict(want[2])
            assert all(md[f] == wd[f] for f in LOGICAL_METRIC_FIELDS), opts
            assert d[t].item() == plain[0][t].item()
            assert reconstruct_path(p.cpu().numpy(), s, t) == path


def test_cuda_v1_solve_matches_single_device(card, tmp_path):
    import torch.distributed as tdist
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        for g in (kronecker(10, 8, seed=1), road_grid(24, seed=2)):
            src = int(np.argmax(g.deg))
            d1, p1, m1 = sssp(g, src, backend="blocked", device=card)
            sg = shard_graph(g, 1)
            before = ops.LAUNCHES.edge_relax_partials
            for backend in ("blocked", "segment_min"):
                d, p, m = sssp_distributed(sg, src, version="v1",
                                           backend=backend, device=card)
                assert torch.equal(d[:g.n].view(torch.int32),
                                   d1.view(torch.int32)), backend
                assert torch.equal(p[:g.n], p1), backend
                m, want = metrics_dict(m), metrics_dict(m1)
                assert all(m[f] == want[f] for f in LOGICAL_METRIC_FIELDS)
            assert ops.LAUNCHES.edge_relax_partials > before
    finally:
        tdist.destroy_process_group()


def test_cuda_v1_alt_p2p_matches_segment_min(card, tmp_path):
    import torch.distributed as tdist
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        for g, seed in ((kronecker(10, 8, seed=1), 3),
                        (road_grid(24, seed=2), 4)):
            lm = build_landmarks(g, 4, device=card)
            rng = np.random.default_rng(seed)
            s, t = (int(v) for v in rng.choice(g.n, 2, replace=False))
            sg = shard_graph(g, 1)
            kw = dict(version="v1", goal="p2p", goal_param=t, device=card)
            plain = sssp_distributed(sg, s, backend="segment_min", **kw)
            want = sssp_distributed(sg, s, backend="segment_min",
                                    landmarks=lm, **kw)
            before = (ops.LAUNCHES.edge_relax_partials,
                      ops.LAUNCHES.edge_relax_partials_alt)
            d, p, m = sssp_distributed(sg, s, backend="blocked",
                                       landmarks=lm, **kw)
            assert ops.LAUNCHES.edge_relax_partials == before[0]
            assert ops.LAUNCHES.edge_relax_partials_alt > before[1]
            assert torch.equal(d.view(torch.int32),
                               want[0].view(torch.int32))
            assert torch.equal(p, want[1])
            md, wd = metrics_dict(m), metrics_dict(want[2])
            assert all(md[f] == wd[f] for f in LOGICAL_METRIC_FIELDS)
            assert d[t].item() == plain[0][t].item()
            assert reconstruct_path(p.cpu().numpy(), s, t) == \
                reconstruct_path(plain[1].cpu().numpy(), s, t)
    finally:
        tdist.destroy_process_group()


_FLASH_TOL = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


def _normal(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        device, dtype)


def _flash_checked(fn, kind, *args, **kw):
    """``fn(*args, **kw)`` on the card: exactly one launch, of design
    ``kind`` (``fops.variant``'s name)."""
    counts = lambda: {n: getattr(fops.LAUNCHES, f"flash_attention_{n}")
                      for n in fops.VARIANTS}
    before, calls = counts(), fops.LAUNCHES.flash_attention
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    after = counts()
    assert fops.LAUNCHES.flash_attention == calls + 1
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == kind) for n in after}
    return out


@pytest.mark.parametrize("dtype,tol", _FLASH_TOL, ids=["f32", "bf16"])
def test_cuda_flash_attention_matches_plain_version(card, dtype, tol):
    # S not a multiple of any tile, GQA groups 1, 2 and 8, D 16 to 128
    rng = np.random.default_rng(11)
    shapes = [(2, 4, 2, 200, 32), (1, 8, 8, 130, 64), (2, 16, 2, 67, 128),
              (1, 16, 8, 300, 128), (1, 4, 4, 257, 16), (3, 8, 1, 5, 64)]
    masks = [(True, 0), (True, 31), (False, 0), (False, 40)]
    for (b, h, hkv, s, d), (causal, window) in itertools.product(shapes,
                                                                 masks):
        q = _normal(rng, (b, h, s, d), dtype, card)
        k = _normal(rng, (b, hkv, s, d), dtype, card)
        v = _normal(rng, (b, hkv, s, d), dtype, card)
        before = fops.LAUNCHES.flash_attention
        out = fops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fops.LAUNCHES.flash_attention == before + 1
        want = fops.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype,tol", _FLASH_TOL, ids=["f32", "bf16"])
def test_cuda_flash_attention_decode_positions(card, dtype, tol):
    # the decode step's call: one query per slot at its own position over
    # one layer of a [L, B, T, KV, D] cache, read in place; keys at -1
    # (never written) and ring-buffer positions
    rng = np.random.default_rng(12)
    for hg, d, t, window in ((2, 128, 4096, 0), (1, 64, 300, 0),
                             (8, 128, 513, 0), (2, 16, 64, 0),
                             (2, 128, 256, 256)):
        b, kv = 5, 2
        cache = _normal(rng, (2, b, t, kv, d), dtype, card)
        kc, vc = cache[0], cache[1]
        q = _normal(rng, (b, 1, kv, hg, d), dtype, card)
        pos = torch.from_numpy(rng.integers(0, 3 * t, b).astype(np.int32)
                               ).to(card)
        pad = torch.arange(t, device=card, dtype=torch.int32).expand(
            b, t).clone()
        pad[:, rng.integers(0, t, t // 3)] = -1
        for k_pos in (None, pad, ring_positions(pos, t)):
            args = (q, kc, vc, pos[:, None], k_pos)
            out = _flash_checked(fops.flash_attention_pos, "split", *args,
                                 causal=True, window=window)
            want = fops.flash_attention_pos_ref(*args, causal=True,
                                                window=window)
            torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("dtype,tol", _FLASH_TOL, ids=["f32", "bf16"])
def test_cuda_flash_attention_query_chunk(card, dtype, tol):
    # a chunk of queries at positions 300..369 over 400 keys: with keys at
    # 0..T-1 (null k_pos) the causal and windowed ranges are cut from the
    # queries' positions; with -1 padded keys every tile is scanned
    rng = np.random.default_rng(13)
    b, s, t, kv, hg, d = 3, 70, 400, 2, 4, 64
    q = _normal(rng, (b, s, kv, hg, d), dtype, card)
    k = _normal(rng, (b, t, kv, d), dtype, card)
    v = _normal(rng, (b, t, kv, d), dtype, card)
    q_pos = (300 + torch.arange(s, device=card, dtype=torch.int32)).expand(
        b, s)
    pad = torch.arange(t, device=card, dtype=torch.int32).expand(b, t).clone()
    pad[:, rng.integers(0, t, t // 3)] = -1
    kind = "tc" if dtype == torch.bfloat16 else "simt"
    for k_pos in (None, pad):
        for causal, window in ((True, 0), (True, 40), (False, 40)):
            args = (q, k, v, q_pos, k_pos)
            kw = dict(causal=causal, window=window)
            out = _flash_checked(fops.flash_attention_pos, kind, *args, **kw)
            want = fops.flash_attention_pos_ref(*args, **kw)
            torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("s,hg,d", [(64, 2, 128), (200, 2, 128),
                                    (2048, 2, 128), (3072, 2, 128),
                                    (130, 8, 64)])
def test_cuda_flash_tc_matches_plain_version(card, s, hg, d):
    # the tensor-core prefill design at qwen3-0.6b's widths (8 KV heads of
    # 2, D = 128; S = T up to the longest padded prompt) and at D = 64,
    # HG = 8; ragged row tiles, causal, non-causal and window 31
    rng = np.random.default_rng(s + d)
    kv = 8 if d == 128 else 2
    q = _normal(rng, (1, s, kv, hg, d), torch.bfloat16, card)
    k = _normal(rng, (1, s, kv, d), torch.bfloat16, card)
    v = _normal(rng, (1, s, kv, d), torch.bfloat16, card)
    for causal, window in ((True, 0), (False, 0), (True, 31)):
        kw = dict(causal=causal, window=window)
        out = _flash_checked(fops.flash_attention_pos, "tc", q, k, v, **kw)
        want = fops.flash_attention_pos_ref(q, k, v, **kw)
        torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("dtype,tol", _FLASH_TOL, ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [300, 4096])
def test_cuda_flash_split_matches_plain_version(card, dtype, tol, t):
    # the split-KV decode design over one layer of a qwen3-0.6b-shaped
    # cache (8 slots, 8 KV heads of 2): positions below T - 1, -1 padding
    # (a slot with no written key gives 0), a ring buffer, and a window
    rng = np.random.default_rng(t)
    b, kv, hg, d = 8, 8, 2, 128
    cache = _normal(rng, (2, 2, b, t, kv, d), dtype, card)
    kc, vc = cache[0, 1], cache[1, 1]
    q = _normal(rng, (b, 1, kv, hg, d), dtype, card)
    pos = torch.from_numpy(rng.integers(0, t - 1, b).astype(np.int32)).to(
        card)
    pad = torch.arange(t, device=card, dtype=torch.int32).expand(b, t).clone()
    pad[:, rng.integers(0, t, t // 3)] = -1
    pad[3] = -1
    lap2 = pos + 2 * t                  # the ring in its third lap
    ring = ring_positions(lap2, t)
    cases = [(pos, None, 0), (pos, pad, 0), (lap2, ring, 0), (pos, None, 97),
             (lap2, ring, t)]
    for q_pos, k_pos, window in cases:
        args = (q, kc, vc, q_pos[:, None], k_pos)
        out = _flash_checked(fops.flash_attention_pos, "split", *args,
                             causal=True, window=window)
        want = fops.flash_attention_pos_ref(*args, causal=True,
                                            window=window)
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        if k_pos is pad:
            assert not out[3].any()


def _bits(out, want):
    """Bitwise equal, NaN where the other is NaN."""
    out, want = out.cpu(), want.cpu()
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(out), nan)) and bool(torch.equal(
        out.masked_fill(nan, 0).view(torch.int32),
        want.masked_fill(nan, 0).view(torch.int32)))


# the reference kernel test's shapes, then L = 1, a wide row (two passes
# of 32 lanes) and a batch that leaves part of a block idle
_BAG_SHAPES = [(64, 16, 4, 3), (300, 32, 8, 7), (1000, 64, 2, 20),
               (50, 8, 33, 1), (200, 256, 5, 40), (500, 64, 1000, 50)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_embedding_bag_matches_plain_version(card, dtype):
    rng = np.random.default_rng(14)
    for (v, d, b, l), mode, weighted in itertools.product(
            _BAG_SHAPES, ("sum", "mean"), (False, True)):
        table = _normal(rng, (v, d), dtype, card)
        ids = torch.from_numpy(rng.integers(0, v, (b, l)).astype(
            np.int32)).to(card)
        w = (torch.from_numpy(rng.random((b, l)).astype(np.float32)).to(card)
             if weighted else None)
        if weighted:
            w[0] = 0.0                    # a bag of zero weights: mean 0
        before = eops.LAUNCHES.embedding_bag
        out = eops.embedding_bag(table, ids, w, mode=mode)
        torch.cuda.synchronize()
        assert eops.LAUNCHES.embedding_bag == before + 1
        want = eops.embedding_bag_ref(table, ids, w, mode=mode)
        assert out.dtype == torch.float32 and out.shape == (b, d)
        assert _bits(out, want), (v, d, b, l, mode, weighted, dtype)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_cuda_embedding_bag_out_of_range_ids(card, mode):
    """-1 and -V wrap to id + V; V, 2V and ids below -V clamp into
    [0, V-1], as in the plain version."""
    rng = np.random.default_rng(15)
    v = 40
    table = _normal(rng, (v, 32), torch.float32, card)
    ids = torch.tensor([[-1, 0, -v, 3], [v, 2 * v, -v - 1, 2 ** 31 - 1],
                        [-2 ** 31, 5, v - 1, -1]], dtype=torch.int32,
                       device=card)
    w = torch.from_numpy(rng.random((3, 4)).astype(np.float32)).to(card)
    out = eops.embedding_bag(table, ids, w, mode=mode)
    torch.cuda.synchronize()
    assert bool(out.isfinite().all())
    assert _bits(out, eops.embedding_bag_ref(table, ids, w, mode=mode))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_cuda_embedding_layer_matches_cpu(card, mode):
    """The recsys layer through the kernel (one launch of its masked
    entry) equals the same call on the CPU (its plain version), NaN bags
    included."""
    rng = np.random.default_rng(16)
    v, b, l = 5000, 300, 50
    table = rng.normal(0, 0.02, (v, 64)).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    mask = rng.random((b, l)) < 0.8
    mask[3] = False
    ids[5, 7], mask[5, 7] = v, True                # NaN bag
    ids[6, 8], mask[6, 8] = 2 * v, False           # masked out: no effect
    ids[7, 0] = -1                                 # wraps
    args = [torch.from_numpy(a) for a in (table, ids, mask)]
    before = (eops.LAUNCHES.embedding_bag, eops.LAUNCHES.embedding_bag_masked)
    out = remb.embedding_bag_batched(*(a.to(card) for a in args), mode=mode)
    torch.cuda.synchronize()
    assert (eops.LAUNCHES.embedding_bag,
            eops.LAUNCHES.embedding_bag_masked) == (before[0], before[1] + 1)
    want = remb.embedding_bag_batched(*args, mode=mode)
    assert _bits(out, want)
    assert torch.isnan(out[5]).all() and bool(out[6].isfinite().all())
    assert not out[3].any()


def test_cuda_embedding_bag_wrapper_refuses(card):
    table = torch.zeros((10, 16), device=card)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple of 4"):
        eops.embedding_bag(torch.zeros((10, 6), device=card), ids)
    with pytest.raises(TypeError, match="int32"):
        eops.embedding_bag(table, ids.long())
    with pytest.raises(ValueError, match="is on cpu"):
        eops.embedding_bag(table, ids.cpu())
    with pytest.raises(ValueError, match="is on cpu"):
        eops.embedding_bag(table, ids, torch.ones((2, 3)))
    with pytest.raises(ValueError, match="aligned"):
        eops.embedding_bag(torch.zeros(164, device=card)[1:161].view(10, 16),
                           ids)
    before = eops.LAUNCHES.embedding_bag
    empty = eops.embedding_bag(table, ids[:0])
    assert empty.shape == (0, 16) and eops.LAUNCHES.embedding_bag == before


# the masked entry: bag lengths across the staged path's list of 64
# lookups, rows narrower and wider than one pass of 32 chunks; B = 4000
# takes the direct path for D >= 64, smaller B the staged one
_MASKED_L = (0, 1, 7, 50, 65, 200)
_MASKED_D = (16, 64, 128, 512)
_MASKED_B = (1, 512, 4000)


def _masked_case(rng, v, b, l, device):
    """Zipf ids (rows repeat within a chunk) with some outside [-V, V) and
    some wrapping, a mask with an all-masked bag."""
    ids = (rng.zipf(1.2, (b, l)) - 1) % v
    ids = np.where(rng.random((b, l)) < 0.05, -1 - ids, ids)
    ids[rng.random((b, l)) < 0.01] = v + 3
    mask = rng.random((b, l)) < 0.75
    if b > 1:
        mask[1] = False
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_embedding_bag_masked_matches_plain_version(card, dtype):
    """Bitwise against ``embedding_bag_masked_ref`` on the card, through
    the wrapper (one launch of the masked entry, none of the weighted), at
    B = 1 and 512 (the staged path) and 4000 (the direct path for D >= 64);
    without a mask too."""
    rng = np.random.default_rng(17)
    v = 3000
    for d in _MASKED_D:
        table = _normal(rng, (v, d), dtype, card)
        for l, b, mode in itertools.product(_MASKED_L, _MASKED_B,
                                            ("sum", "mean")):
            ids, mask = _masked_case(rng, v, b, l, card)
            ids = torch.where(mask, ids, 2 * v)     # masked out: not read
            before = (eops.LAUNCHES.embedding_bag,
                      eops.LAUNCHES.embedding_bag_masked)
            out = eops.embedding_bag_masked(table, ids, mask, mode=mode)
            torch.cuda.synchronize()
            assert (eops.LAUNCHES.embedding_bag,
                    eops.LAUNCHES.embedding_bag_masked) == (before[0],
                                                            before[1] + 1)
            want = eops.embedding_bag_masked_ref(table, ids, mask, mode=mode)
            assert out.dtype == torch.float32 and out.shape == (b, d)
            assert _bits(out, want), (d, l, b, mode, dtype)
        # masked-out lookups of a row of inf and NaN add nothing
        ids, mask = _masked_case(rng, v, 512, 50, card)
        used = torch.where(ids < 0, ids + v, ids)[mask]
        free = int(torch.isin(torch.arange(v, device=card), used,
                              invert=True).nonzero()[0])
        table[free, ::2], table[free, 1::2] = float("inf"), float("nan")
        ids = torch.where(mask, ids, free)
        for mode in ("sum", "mean"):
            out = eops.embedding_bag_masked(table, ids, mask, mode=mode)
            want = eops.embedding_bag_masked_ref(table, ids, mask, mode=mode)
            assert _bits(out, want), (d, mode, dtype, "non-finite row")
            nan_bags = ((ids < -v) | (ids >= v)) & mask
            assert bool(out[~nan_bags.any(1)].isfinite().all())
        out = eops.embedding_bag_masked(table, torch.where(mask, ids, 0))
        assert _bits(out, eops.embedding_bag_masked_ref(
            table, torch.where(mask, ids, 0)))      # no mask: all in


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_embedding_bag_weighted_paths_match_plain_version(card, dtype):
    """The weighted entry on both paths, bitwise, at the masked entry's
    bag lengths, widths and batches (weights with zeros and a NaN; runs
    of a repeated row, as the parent layer's padding sent)."""
    rng = np.random.default_rng(18)
    v = 2000
    for d in _MASKED_D:
        table = _normal(rng, (v, d), dtype, card)
        for l, b, mode in itertools.product(_MASKED_L, _MASKED_B,
                                            ("sum", "mean")):
            ids, _ = _masked_case(rng, v, b, l, card)
            ids[:, l // 2:] = 0                  # the parent layer's padding
            w = torch.from_numpy(rng.random((b, l)).astype(
                np.float32)).to(card)
            if l:
                w[0] = 0.0
                w[-1, l // 2] = float("nan")
            want = eops.embedding_bag_ref(table, ids, w, mode=mode)
            got = eops.embedding_bag(table, ids, w, mode=mode)
            assert _bits(got, want), (d, l, b, mode, dtype)


def test_cuda_embedding_bag_graph_replay_equals_eager(card):
    """Both entries captured in a CUDA graph and replayed give the eager
    call's bits."""
    rng = np.random.default_rng(19)
    table = _normal(rng, (5000, 64), torch.float32, card)
    ids, mask = _masked_case(rng, 5000, 700, 50, card)
    w = mask.float()
    calls = (lambda: eops.embedding_bag_masked(table, ids, mask, mode="mean"),
             lambda: eops.embedding_bag(table, ids, w, mode="sum"))
    for call in calls:
        eager = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert _bits(out, eager)


def test_cuda_embedding_bag_masked_wrapper_refuses(card):
    table = torch.zeros((10, 16), device=card)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=card)
    mask = torch.ones((2, 3), dtype=torch.bool, device=card)
    with pytest.raises(TypeError, match="mask must be torch.bool"):
        eops.embedding_bag_masked(table, ids, mask.float())
    with pytest.raises(ValueError, match="do not match"):
        eops.embedding_bag_masked(table, ids, mask[:1])
    with pytest.raises(ValueError, match="is on cpu"):
        eops.embedding_bag_masked(table, ids, mask.cpu())
    with pytest.raises(ValueError, match="is on cpu"):
        eops.embedding_bag_masked(table, ids.cpu(), mask)
    before = eops.LAUNCHES.embedding_bag_masked
    empty = eops.embedding_bag_masked(table, ids[:0], mask[:0])
    assert empty.shape == (0, 16)
    assert eops.LAUNCHES.embedding_bag_masked == before


# ---------------------------------------------------------------------------
# edge_relax over slots (sssp_batch) and the facade
# ---------------------------------------------------------------------------

def _slot_states(rng, bg, n_slots, card):
    """``n_slots`` states of :func:`_state` stacked ``[S, n_out]``, with
    windows and (for ALT) lower bounds and prune bounds per slot."""
    rows = [_state(rng, bg, int(rng.choice([3, 40, -1])), card,
                   lb=float(rng.integers(0, 3)), ub=float(rng.integers(3, 8)))
            for _ in range(n_slots)]
    dist, paths, parent = (torch.stack([r[k] for r in rows])
                           for k in range(3))
    lb, ub = (torch.stack([r[k] for r in rows]) for k in (3, 4))
    alt_lb = torch.from_numpy((rng.integers(0, 8, (n_slots, bg.n_out)) / 4)
                              .astype(np.float32)).to(card)
    bound = torch.from_numpy(rng.choice([2.0, np.inf, 0.0, 3.0], n_slots)
                             .astype(np.float32)).to(card)
    return (dist, paths, parent, lb, ub), (alt_lb, bound)


@pytest.mark.parametrize("n_slots", [1, 3, 8])
@pytest.mark.parametrize("alt", [False, True], ids=["plain", "alt"])
def test_cuda_batch_kernel_matches_plain_version(card, n_slots, alt):
    """One batched launch over an active list (every slot, and one that
    skips slots), twice: each active slot's vals, wins and counters
    bitwise the plain version's and the one-state call's on its row; the
    launch counted once; the scratch left clean."""
    rng = np.random.default_rng(40 + n_slots)
    bg = build_blocked(_graph(rng, ties=True), block_v=256, tile_e=64,
                       device=card)
    (dist, paths, parent, lb, ub), alt_ops = _slot_states(rng, bg, n_slots,
                                                          card)
    extra = alt_ops if alt else ()
    args = (dist, paths, parent, bg.src, bg.dst, bg.w, bg.tile_first, lb,
            ub, *extra)
    kw = dict(tile_e=bg.tile_e, n_out=bg.n_out)
    counter = "edge_relax_batch_alt" if alt else "edge_relax_batch"
    lists = [list(range(n_slots)), list(range(0, n_slots, 2))]
    if n_slots > 2:
        lists.append([n_slots - 1])
    for act in lists:
        active = torch.tensor(act, dtype=torch.int32, device=card)
        want = ref.edge_relax_batch_ref(*args, **kw, active=active)
        for _ in range(2):
            before = getattr(ops.LAUNCHES, counter)
            vals, wins, cnt = ops.relax_bucket(*args, **kw, index=bg.index,
                                               active=active)
            torch.cuda.synchronize()
            assert getattr(ops.LAUNCHES, counter) == before + 1
            for i in act:
                assert torch.equal(vals[i].view(torch.int32),
                                   want[0][i].view(torch.int32)), (act, i)
                assert torch.equal(wins[i], want[1][i]), (act, i)
                assert cnt[i].tolist() == want[2][i].tolist(), (act, i)
                one = ops.relax_bucket(
                    dist[i], paths[i], parent[i], bg.src, bg.dst, bg.w,
                    bg.tile_first, lb[i], ub[i],
                    *(() if not alt else (alt_ops[0][i], alt_ops[1][i])),
                    **kw, index=bg.index)
                assert torch.equal(one[0].view(torch.int32),
                                   vals[i].view(torch.int32)), (act, i)
                assert torch.equal(one[1], wins[i]) and torch.equal(
                    one[2], cnt[i]), (act, i)
    for flags, _, keys in ops._SCRATCH.values():
        assert not bool(flags.any())
        assert bool((keys == ref.EMPTY_KEY).all())


def test_cuda_batched_facade_matches_single_solves(card):
    """The facade's batched tree and ALT p2p specs on the blocked backend:
    each slot bitwise the single solve, one batched launch per iteration
    and no one-state launch."""
    from repro_torch.api import EngineConfig, SolveSpec, Solver
    g = kronecker(10, 8, seed=1)
    solver = Solver.open(g, EngineConfig(backend="blocked", use_alt=True,
                                         n_landmarks=4))
    rng = np.random.default_rng(9)
    srcs = [int(np.argmax(g.deg))] + [int(v) for v in
                                      rng.choice(g.n, 3, replace=False)]
    tgts = [int(v) for v in rng.choice(g.n, 4, replace=False)]
    for spec, counter in ((SolveSpec.tree(srcs), "edge_relax_batch"),
                          (SolveSpec.p2p(srcs, tgts),
                           "edge_relax_batch_alt")):
        ops.LAUNCHES.reset()
        res = solver.solve(spec)
        torch.cuda.synchronize()
        launches = getattr(ops.LAUNCHES, counter)
        assert ops.LAUNCHES.edge_relax == 0
        assert ops.LAUNCHES.edge_relax_alt == 0
        assert launches == int(res.metrics.n_host_syncs.max())
        for i, s in enumerate(srcs):
            one = solver.solve(SolveSpec.tree(s) if spec.kind == "tree"
                               else SolveSpec.p2p(s, tgts[i]))
            assert torch.equal(res.dist[i].view(torch.int32),
                               one.dist.view(torch.int32)), (spec.kind, i)
            assert torch.equal(res.parent[i], one.parent), (spec.kind, i)
            for f in LOGICAL_METRIC_FIELDS:
                assert int(getattr(res.metrics, f)[i]) == int(
                    getattr(one.metrics, f)), (spec.kind, i, f)
