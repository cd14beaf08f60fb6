"""Port: the vertex->tile index and the frontier-driven schedule.

The one-round CUDA kernels (``edge_relax``, ``edge_relax_partials``)
find their tiles from the layout's :class:`TileIndex` and the frontier
instead of reading ``src`` of every slot.  On the CPU this file holds:

* the index against its definition (per source, the ascending distinct
  tiles holding a finite-weight slot of it; the forced tiles), on
  one-bucket and multi-bucket layouts, shard layouts at P = 1, 2 and 4,
  layouts with real edges of weight +inf and with empty slabs;
* ``ref.frontier_schedule`` (the kernels' prepass written plainly)
  against the port's ``ref.schedule_tiles`` and the JAX reference's
  ``schedule_tiles`` on the same numpy inputs: the same tile set and
  count;
* the counters ``ops.relax_bucket`` now returns against
  ``ref._slab_counters``, the plain gather pass over every slot that
  ``core/relax.py::_blocked_relax`` ran before, and the same round
  restricted to the scheduled tiles' slots (the kernels' work);
* the ``blocked`` round's ``RoundMetrics``, ``dist`` and ``parent``, and a
  whole ``blocked`` solve, bitwise against the JAX reference.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.generators as rgen
from repro.core import relax as rrelax
from repro.core.graph import build_blocked as ref_build_blocked
from repro.core.sssp import sssp as ref_sssp
from repro.kernels.edge_relax.edge_relax import schedule_tiles as jax_sched
from repro_torch import convert
from repro_torch.core import relax as trelax
from repro_torch.core.distributed import shard_blocked
from repro_torch.core.graph import (TileIndex, build_blocked, build_csr,
                                    default_geometry)
from repro_torch.core.sssp import sssp
from repro_torch.kernels.edge_relax import ops, ref
from test_torch_graph import ref_arrays
from test_torch_sssp import _np, _port, assert_same
from release_xla import release_compiled  # noqa: F401


def _graph(seed, n, m, *, inf_frac=0.0, lo_frac=1.0, ties=False):
    """A random port ``HostGraph``: sources in the lowest ``lo_frac`` of
    the ids (the rest of the source blocks hold no edge: empty slabs),
    ``inf_frac`` of the edges of weight +inf."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, max(int(n * lo_frac), 1), m)
    v = rng.integers(0, n, m)
    keep = u != v
    w = (rng.integers(1, 4, keep.sum()).astype(np.float64) if ties
         else rng.random(keep.sum()) + 1e-3)
    w[rng.random(w.size) < inf_frac] = np.inf
    return build_csr(n, u[keep], v[keep], w)


GRAPHS = {
    "plain": lambda: _graph(0, 700, 5000),
    "inf-edges": lambda: _graph(1, 600, 4000, inf_frac=0.2, ties=True),
    "empty-slabs": lambda: _graph(2, 900, 3000, lo_frac=0.3),
    "no-edges": lambda: _graph(3, 200, 0),
    "hubs": lambda: convert.from_reference(
        ref_arrays(rgen.kronecker(8, 32, seed=9)), "cpu"),
}
# (block_v, tile_e); None: the one-bucket layout derived for the card
GEOMETRIES = [(None, 64), (None, 256), (64, 32), (1024, 64), (128, 128)]


@functools.lru_cache(maxsize=None)
def _layout(name, geom):
    g = GRAPHS[name]()
    block_v, tile_e = geom
    if block_v is None:
        block_v = default_geometry(g.n, "cuda")[0]
    return g, build_blocked(g, block_v=block_v, tile_e=tile_e, device="cpu")


def _index_by_definition(src, w, tile_first, tile_e, n_src):
    """The index as a list of ascending tile lists per source, and the
    forced tiles, from the slots one by one."""
    per = [set() for _ in range(n_src)]
    for e in np.flatnonzero(np.isfinite(w)):
        per[int(src[e])].add(e // tile_e)
    return [sorted(p) for p in per], np.flatnonzero(tile_first)


def _assert_index(index: TileIndex, src, w, tile_first, tile_e, n_src):
    vt_ptr, vt_tile, forced = (np.asarray(a) for a in index)
    per, want_forced = _index_by_definition(src, w, tile_first, tile_e,
                                            n_src)
    assert vt_ptr.dtype == vt_tile.dtype == forced.dtype == np.int32
    assert vt_ptr.shape == (n_src + 1,) and vt_ptr[0] == 0
    for s in range(n_src):
        assert list(vt_tile[vt_ptr[s]:vt_ptr[s + 1]]) == per[s], s
    # a shard's stacked index may carry padding past the last entry, and
    # repeats of the always-forced tile 0
    assert np.array_equal(np.unique(forced), want_forced)


def _frontiers(n, seed):
    rng = np.random.default_rng(seed)
    yield np.zeros(n, bool)                      # forced tiles only
    yield np.ones(n, bool)
    yield rng.random(n) < 0.05                   # a few vertices
    yield rng.random(n) < 0.5


def _assert_same_schedule(paths, src, w, tile_first, tile_e, index):
    t = torch.from_numpy
    nt = tile_first.shape[0]
    tiles, n = ref.frontier_schedule(t(paths), TileIndex(
        *(t(np.ascontiguousarray(a)) for a in index)), nt)
    ps, pn = ref.schedule_tiles(t(paths), t(src), t(w), t(tile_first),
                                tile_e)
    js, jn = jax_sched(jnp.asarray(paths), jnp.asarray(src), jnp.asarray(w),
                       jnp.asarray(tile_first), tile_e)
    assert int(n) == int(pn) == int(jn) and n.dtype == torch.int32
    k = int(n)
    assert tiles.tolist() == ps[:k].tolist() == np.asarray(js)[:k].tolist()


@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_tile_index_and_schedule_single_device(name, geom):
    g, bg = _layout(name, geom)
    src, w, tf = bg.src.numpy(), bg.w.numpy(), bg.tile_first.numpy()
    _assert_index(bg.index, src, w, tf, bg.tile_e, bg.n_pad)
    for i, front in enumerate(_frontiers(bg.n_pad, 7)):
        _assert_same_schedule(front, src, w, tf, bg.tile_e,
                              tuple(a.numpy() for a in bg.index))


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("geom", [(64, 64), (None, None)], ids=str)
@pytest.mark.parametrize("name", ["plain", "inf-edges", "empty-slabs",
                                  "hubs"])
def test_tile_index_and_schedule_shards(name, geom, p):
    g = GRAPHS[name]()
    block_v, tile_e = geom
    arrays, meta = shard_blocked(g, p, block_v=block_v, tile_e=tile_e,
                                 device="cpu" if block_v else "cuda")
    block = meta.n_src_blocks * meta.block_v
    for q in range(p):
        index = (arrays.vt_ptr[q], arrays.vt_tile[q], arrays.forced[q])
        _assert_index(index, arrays.src[q], arrays.w[q],
                      arrays.tile_first[q], meta.tile_e, block)
        for front in _frontiers(block, q):
            _assert_same_schedule(front, arrays.src[q], arrays.w[q],
                                  arrays.tile_first[q], meta.tile_e, index)


def _round_inputs(bg, seed, *, alt):
    rng = np.random.default_rng(seed)
    n_out = bg.n_out
    dist = rng.integers(0, 6, n_out).astype(np.float32)
    dist[rng.random(n_out) < 0.2] = np.inf
    paths = (rng.random(n_out) < 0.4) & np.isfinite(dist)
    parent = np.where(np.isfinite(dist), rng.integers(0, n_out, n_out),
                      -1).astype(np.int32)
    t = torch.from_numpy
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    args = (t(dist), t(paths), t(parent), bg.src, bg.dst, bg.w,
            bg.tile_first, f32(1.0), f32(4.0))
    if alt:
        lbv = (rng.integers(0, 8, n_out) / 4).astype(np.float32)
        lbv[rng.random(n_out) < 0.15] = np.inf
        args += (t(lbv), f32(5.0))
    return args


def _gather_pass(dist, paths, parent, src, dst, w, lb, ub, alt_lb=None,
                 bound=None):
    """The counting pass over every slot that ``_blocked_relax`` ran in
    plain torch before the kernel counted: ``(n_trav, n_relax,
    n_pruned)``."""
    s = src.long()
    cand, in_window, active = trelax.edge_candidates(
        dist[s], paths[s], parent[s], dst, w, lb, ub)
    n_pruned = 0
    if alt_lb is not None:
        active, pruned = trelax.alt_prune(cand, active, alt_lb[dst.long()],
                                          bound)
        n_pruned = int(pruned.sum())
    return int(in_window.sum()), int(active.sum()), n_pruned


def _scheduled_round(dist, paths, parent, src, dst, w, tile_first, lb, ub,
                     alt_lb=None, bound=None, *, tile_e, index):
    """The kernels' work, plainly: only the slots of the tiles the
    frontier-driven schedule picks, counted as ``relax_tiles`` counts."""
    tiles, n = ref.frontier_schedule(paths, index, tile_first.shape[0])
    slots = (tiles.long()[:, None] * tile_e
             + torch.arange(tile_e)[None, :]).reshape(-1)
    s = src[slots].long()
    c = dist[s] + w[slots]
    ok = paths[s] & (c >= lb) & (c < ub)
    notpar = dst[slots] != parent[s]
    keep = ok if alt_lb is None else ok & (
        c + alt_lb[dst[slots].long()] <= bound)
    return [int(ok.sum()), int((keep & notpar).sum()), int(n),
            int((ok & ~keep & notpar).sum())]


@pytest.mark.parametrize("alt", [False, True], ids=["plain", "alt"])
@pytest.mark.parametrize("geom", GEOMETRIES[::2], ids=str)
@pytest.mark.parametrize("name", ["plain", "inf-edges", "empty-slabs",
                                  "hubs"])
def test_relax_bucket_counters(name, geom, alt):
    _, bg = _layout(name, geom)
    args = _round_inputs(bg, 11, alt=alt)
    kw = dict(tile_e=bg.tile_e, n_out=bg.n_out)
    vals, wins, counts = ops.relax_bucket(*args, index=bg.index, **kw)
    assert counts.dtype == torch.int32 and counts.shape == (4,)
    got = counts.tolist()
    dist, paths, parent, src, dst, w, tf, lb, ub, *cut = args
    s = src.long()
    c = dist[s] + w
    ok = paths[s] & (c >= lb) & (c < ub)
    fail = None if not cut else c + cut[0][dst.long()] > cut[1]
    assert got == [int(x) for x in ref._slab_counters(
        paths[s], w, dst, parent[s], ok, tf, bg.tile_e, fail)]
    trav, relax, pruned = _gather_pass(dist, paths, parent, src, dst, w, lb,
                                       ub, *cut)
    _, n_tiles = ref.schedule_tiles(paths, src, w, tf, bg.tile_e)
    assert got == [trav, relax, int(n_tiles), pruned]
    assert got == _scheduled_round(*args, tile_e=bg.tile_e, index=bg.index)
    pv, pw = ref.edge_relax_ref(dist, paths, src, dst, w, lb, ub, *cut,
                                n_out=bg.n_out)
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(wins, pw)


@functools.lru_cache(maxsize=None)
def _ref_layouts(maker, kwargs, block_v, tile_e):
    rg = getattr(rgen, maker)(**dict(kwargs))
    rbg = ref_build_blocked(rg.to_device(), block_v=block_v, tile_e=tile_e,
                            use_kernel=False)
    return rg, rbg, convert.from_reference(ref_arrays(rbg), "cpu")


ROUND_GRAPHS = [("kronecker", (("scale", 8), ("edge_factor", 16),
                               ("seed", 3))),
                ("road_grid", (("side", 16), ("seed", 5)))]


@pytest.mark.parametrize("alt", [False, True], ids=["plain", "alt"])
@pytest.mark.parametrize("maker,kwargs", ROUND_GRAPHS,
                         ids=[m for m, _ in ROUND_GRAPHS])
def test_blocked_round_metrics_match_reference(maker, kwargs, alt):
    rg, rbg, bg = _ref_layouts(maker, kwargs, 64, 64)
    _assert_index(bg.index, bg.src.numpy(), bg.w.numpy(),
                  bg.tile_first.numpy(), bg.tile_e, bg.n_pad)
    rng = np.random.default_rng(13)
    n = rg.n
    for window in ((0.0, np.inf), (0.5, 1.5)):
        dist = (rng.random(n) * 2).astype(np.float32)
        dist[rng.random(n) < 0.3] = np.inf
        parent = np.where(np.isfinite(dist), rng.integers(0, n, n),
                          -1).astype(np.int32)
        front = (rng.random(n) < 0.3) & np.isfinite(dist)
        lb, ub = np.float32(window[0]), np.float32(window[1])
        cut = ()
        if alt:
            lbv = (rng.random(n) * 0.5).astype(np.float32)
            lbv[rng.random(n) < 0.1] = np.inf
            cut = (lbv, np.float32(1.2))
        rd, rp, rm = rrelax._blocked_relax(
            rbg, jnp.asarray(dist), jnp.asarray(parent), jnp.asarray(front),
            lb, ub, *(jnp.asarray(c) for c in cut))
        t = lambda a: torch.from_numpy(np.asarray(a))
        td, tp, tm = trelax._blocked_relax(bg, t(dist), t(parent), t(front),
                                           t(lb), t(ub), *map(t, cut))
        np.testing.assert_array_equal(np.asarray(rd).view(np.int32),
                                      td.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(rp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(rm.improved),
                                      tm.improved.numpy())
        for f in ("n_trav", "n_relax", "n_updates", "n_extended",
                  "n_pruned", "n_tiles_scanned", "n_tiles_dense"):
            assert float(getattr(rm, f)) == float(getattr(tm, f)), f
        for f in ("n_trav", "n_relax", "n_updates", "n_extended",
                  "n_pruned"):
            assert getattr(tm, f).dtype == torch.int32, f
        if alt:
            assert int(tm.n_pruned) > 0


@pytest.mark.parametrize("maker,kwargs", ROUND_GRAPHS,
                         ids=[m for m, _ in ROUND_GRAPHS])
def test_blocked_solve_matches_reference(maker, kwargs):
    rg, rbg, bg = _ref_layouts(maker, kwargs, 64, 64)
    src = int(np.argmax(rg.deg))
    want = ref_sssp(rg.to_device(), src, backend="blocked_pallas",
                    use_kernel=False, block_v=64, tile_e=64)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    got = sssp(hg, src, backend="blocked", device="cpu", layout=bg)
    assert_same(_np(want), _port(got), f"{maker} blocked")
    assert float(want[2].n_tiles_scanned) == float(got[2].n_tiles_scanned)
