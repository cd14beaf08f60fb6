"""Port parity: streaming deltas (``repro_torch.delta``) and the engine
hooks they use (``core/sssp.py::repair_relax``,
``core/distributed.py::repair_distributed``, stale landmark sets).

Both packages run on byte-identical inputs: the nine scale-8 graphs and
the edit batches of ``tests/test_delta.py`` (the reference's generators
and its seeded ``make_delta``), carried into the port with
``convert.from_reference``.  Everything is bitwise:

* ``patch_host`` and its ``AppliedDelta`` against the reference's;
  ``patch_sharded`` against the reference's in both of its branches
  (shards rewritten in place, the whole table re-padded);
* ``patch_blocked`` against the port's own ``build_blocked`` of the
  patched host, field for field with the vertex->tile index, at the CPU
  geometry (512 x 512), the card's (one bucket of 256-slot tiles) and
  two small ones, through all three of its branches (buckets rewritten,
  a slab re-bucketed in place, tile counts changed);
* ``repair_state`` and ``repair`` (dist, parent and the logical
  counters) on ``segment_min``, ``blocked`` and fused against the
  reference's ``repair`` on ``segment_min`` (bitwise its Pallas backend
  by the reference's own tests; once here in interpret mode), and
  against a from-scratch solve of the patched graph where the
  reference's own from-scratch solve matches Dijkstra;
* ``repair_distributed`` at v1, v2 and v3 at 1 rank in process and at
  2 and 4 gloo ranks (child processes) against the reference's repair,
  and a batch of the patched graph against its scalar solves;
* a stale landmark set's p2p query against the reference's.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import repro.data.generators as rgen
from repro import delta as rdelta
from repro.core import distributed as rdist
from repro.core import landmarks as rlm
from repro.core.sssp import prepare_layout as ref_prepare
from repro.core.sssp import sssp as ref_sssp
from repro_torch import convert
from repro_torch.api import ConfigError, EngineConfig, SolveSpec, Solver
from repro_torch.core import distributed as tdistributed
from repro_torch.core.baselines import dijkstra_host
from repro_torch.core.graph import build_blocked
from repro_torch.core.landmarks import build_landmarks, load, save
from repro_torch.core.sssp import (LOGICAL_METRIC_FIELDS, metrics_dict,
                                   repair_relax, sssp)
from repro_torch.delta import (EdgeDelta, KIND_SAME, patch_blocked,
                               patch_blocked_with, patch_host, patch_sharded,
                               patch_sharded_with, repair, repair_state)
from repro_torch.serve.queries import reconstruct_path
from test_delta import benchmark_graphs, make_delta, unique_undirected
from test_torch_alt_p2p import lm_arrays
from test_torch_graph import ref_arrays
from release_xla import release_compiled  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"
CHILD_TIMEOUT_S = 120
NAMES = list(benchmark_graphs())
HOST_FIELDS = ("src", "dst", "w", "row_ptr", "deg", "rtow")
LAYOUT_TENSORS = ("src", "dst", "w", "tile_dst", "tile_first",
                  "bucket_nonempty", "deg")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the solves here are many tiny ops: threads only add overhead
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_host(rg):
    return convert.from_reference(ref_arrays(rg), "cpu")


def port_delta(rd) -> EdgeDelta:
    """The port's :class:`EdgeDelta` of a reference one (the same edits,
    in the same order)."""
    rows = lambda arrays: list(zip(*(a.tolist() for a in arrays)))
    return EdgeDelta(add=rows(rd.add), remove=rows(rd.remove),
                     reweight=rows(rd.reweight), symmetrize=rd.symmetrize)


@functools.lru_cache(maxsize=None)
def _graphs():
    return {name: (rg, port_host(rg))
            for name, rg in benchmark_graphs().items()}


@functools.lru_cache(maxsize=None)
def _case(name):
    """A graph's edit batch (``test_delta.py``'s repair seeds), both
    packages' patched hosts, and the reference's tree solve before the
    delta and its repair after it."""
    rg, hg = _graphs()[name]
    rd = make_delta(rg, np.random.default_rng(
        zlib.crc32(name.encode()) % 1000 + 3))
    rnew, rapplied = rdelta.patch_host(rg, rd)
    src = int(np.argmax(rg.deg))
    d0, p0, _ = ref_sssp(rg.to_device(), src)
    g_new = rnew.to_device()
    rep = rdelta.repair(g_new, rnew, d0, p0, rapplied)
    return dict(rg=rg, hg=hg, rd=rd, delta=port_delta(rd), rnew=rnew,
                rapplied=rapplied, src=src, d0=np.asarray(d0),
                p0=np.asarray(p0), rep=rep)


def assert_host_equal(ref, got, what):
    for f in HOST_FIELDS:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (what, f)
    assert (ref.n, ref.max_w) == (got.n, got.max_w), what


def assert_applied_equal(ref, got, what):
    for f in ("src", "dst", "kind"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)
    assert (ref.decrease_only, ref.safe_stale, ref.n_edits) == \
        (got.decrease_only, got.safe_stale, got.n_edits), what


def assert_layout_equal(want, got, what):
    for f in ("n", "block_v", "n_blocks", "n_dst_blocks", "tile_e",
              "dense_grid_tiles", "slab_ptr"):
        assert getattr(want, f) == getattr(got, f), (what, f)
    for f in LAYOUT_TENSORS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert torch.equal(a, b), (what, f)
    for f, a, b in zip(want.index._fields, want.index, got.index):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, "index", f)
        assert torch.equal(a, b), (what, "index", f)


def assert_repair_equal(ref, got, what, counters=True):
    """dist/parent bitwise, and the logical counters equal."""
    rd_, rp_, rm = ref[:3]
    d, p, m = got[:3]
    assert np.asarray(rd_).tobytes() == d.numpy().tobytes(), (what, "dist")
    assert np.asarray(rp_).tobytes() == p.numpy().tobytes(), (what, "parent")
    if counters:
        got_m = metrics_dict(m)
        bad = {f: (int(getattr(rm, f)), got_m[f])
               for f in LOGICAL_METRIC_FIELDS
               if int(getattr(rm, f)) != got_m[f]}
        assert not bad, (what, bad)


def matches_dijkstra(hg, dist, src) -> bool:
    """Whether a stepping solve's ``dist`` matches Dijkstra (queue 3 item
    1: the reference, and the port with it, can return too-long
    distances)."""
    want, _ = dijkstra_host(hg, src)
    got = dist.numpy()
    return np.allclose(np.where(np.isfinite(got), got, -1.0),
                       np.where(np.isfinite(want), want, -1.0), rtol=1e-4,
                       atol=1e-5)


# ---------------------------------------------------------------------------
# (a) patch_host, AppliedDelta, EdgeDelta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_patch_host_matches_reference(name):
    rg, hg = _graphs()[name]
    # test_delta.py's patch seeds, and its repair seeds (_case)
    rd = make_delta(rg, np.random.default_rng(
        zlib.crc32(name.encode()) % 1000))
    for delta in (rd, _case(name)["rd"]):
        rnew, rapplied = rdelta.patch_host(rg, delta)
        new, applied = patch_host(hg, port_delta(delta))
        assert_host_equal(rnew, new, name)
        assert_applied_equal(rapplied, applied, name)
        assert applied.n_edits == 2 * delta.n_edits


def test_edits_reject_what_the_reference_rejects():
    rg, hg = _graphs()["gr_8"]
    e = unique_undirected(rg)[0]
    u, v = int(rg.src[e]), int(rg.dst[e])
    for bad in (EdgeDelta(remove=[(u, v), (u, v)]),     # duplicate target
                EdgeDelta(remove=[(hg.n + 7, 0)]),      # out of range
                EdgeDelta(remove=[(u, u)])):            # not an edge
        with pytest.raises(ValueError):
            patch_host(hg, bad)
    for bad in ([(0, 1, -1.0)], [(0, 1, float("inf"))], [(0.5, 1, 1.0)],
                [(0, 1)]):
        with pytest.raises(ValueError):
            EdgeDelta(add=bad)
    assert not EdgeDelta()
    assert EdgeDelta(remove=[(u, v)]).n_edits == 1
    same = float(np.float32(rg.w[e]))
    _, applied = patch_host(hg, EdgeDelta(reweight=[(u, v, same)]))
    assert (applied.kind == KIND_SAME).all()
    assert applied.decrease_only and applied.safe_stale


# ---------------------------------------------------------------------------
# (b) patch_sharded (both branches) and patch_blocked (all three)
# ---------------------------------------------------------------------------

def _grow_delta(hg, n_shards, k):
    """``k`` undirected additions from the first vertex of the shard with
    the most slots, so that it outgrows ``e_max``."""
    block = -(-hg.n // n_shards)
    q = int(np.argmax(np.bincount(hg.src // block, minlength=n_shards)))
    u = q * block
    return EdgeDelta(add=[(u, (u + 1 + i) % hg.n, 0.5 + i / 64)
                          for i in range(k)])


@pytest.mark.parametrize("branch", ["in_place", "regrown"])
@pytest.mark.parametrize("name", ["gr_4", "Road", "Urand", "Kron"])
def test_patch_sharded_matches_reference(name, branch):
    c = _case(name)
    if branch == "in_place":        # no addition: no shard can outgrow
        rdl = make_delta(c["rg"], np.random.default_rng(5), add=False)
        delta = port_delta(rdl)
    else:
        delta = _grow_delta(c["hg"], 8, 40)
        rdl = rdelta.EdgeDelta(add=[tuple(r) for r in zip(
            *(a.tolist() for a in delta.add))])
    rsg, _, _ = rdelta.patch_sharded(rdist.shard_graph(c["rg"], 8), rdl,
                                     host=c["rg"])
    sg = tdistributed.shard_graph(c["hg"], 8)
    before = [a.copy() for a in (sg.src, sg.dst, sg.w)]
    new, new_host, _ = patch_sharded(sg, delta, host=c["hg"])
    assert (new.src.shape[1] > sg.src.shape[1]) == (branch == "regrown")
    for f in ("src", "dst", "w", "deg", "rtow"):
        a, b = np.asarray(getattr(rsg, f)), getattr(new, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (name, f)
        assert a.tobytes() == b.tobytes(), (name, f)
    assert (new.n_edges2, new.n_true) == (int(rsg.n_edges2),
                                          int(rsg.n_true))
    # the input is left as it was; a reshard of the patched host agrees
    assert all(np.array_equal(a, b) for a, b in
               zip(before, (sg.src, sg.dst, sg.w)))
    ref = tdistributed.shard_graph(new_host, 8)
    for f in ("deg", "rtow"):
        assert np.array_equal(getattr(ref, f), getattr(new, f)), f


def _add_delta(hg, rng, k):
    """``k`` undirected additions between random distinct vertices."""
    adds = []
    while len(adds) < k:
        u, v = (int(x) for x in rng.integers(hg.n, size=2))
        if u != v:
            adds.append((u, v, float(np.float32(rng.uniform(0.05, 2.0)))))
    return EdgeDelta(add=adds)


def _branch(old, new) -> str:
    """Which branch a patch took, read from the tensors it returned."""
    if new.src.data_ptr() != old["src"]:
        return "tiles changed"
    return "slab re-bucketed" if old["tile_dst"] != new.tile_dst.tolist() \
        or old["slab"] != new.slab_ptr else "buckets rewritten"


# (block_v, tile_e); None: the CPU default (512 x 512), "card": one
# bucket of 256-slot tiles (core/graph.py::default_geometry on cuda)
GEOMETRIES = {"cpu": None, "card": "card", "64x64": (64, 64),
              "32x16": (32, 16)}
# the branches each geometry takes over the nine graphs (the third, a
# slab re-bucketed in place, has a test of its own below)
WANT = {"buckets rewritten", "tiles changed"}


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_patch_blocked_equals_rebuild(geom):
    seen = set()
    for name in NAMES:
        c = _case(name)
        hg = c["hg"]
        g = GEOMETRIES[geom]
        opts = {} if g is None else dict(
            block_v=-(-hg.n // 256) * 256, tile_e=256) if g == "card" \
            else dict(block_v=g[0], tile_e=g[1])
        rng = np.random.default_rng(zlib.crc32(name.encode()) % 997)
        for delta in (c["delta"], _add_delta(hg, rng, 200),
                      _add_delta(hg, rng, 3)):
            layout = build_blocked(hg, device="cpu", **opts)
            old = dict(src=layout.src.data_ptr(),
                       tile_dst=layout.tile_dst.tolist(),
                       slab=layout.slab_ptr)
            new, new_host, applied = patch_blocked(layout, delta, host=hg)
            want = build_blocked(new_host, device="cpu", **opts)
            assert_layout_equal(want, new, f"{geom}/{name}")
            seen.add(_branch(old, new))
    assert WANT <= seen, (geom, seen)


def _rebucket_delta(hg, bv, te):
    """A directed delta that moves one slot of a slab from a bucket whose
    last tile it alone fills to a bucket whose tiles are full: the slab
    keeps its tile count, two of its buckets change theirs.  None if the
    graph has no such pair."""
    nb = -(-hg.n // bv)
    src, dst = hg.src.astype(np.int64), hg.dst.astype(np.int64)
    counts = np.bincount((src // bv) * nb + dst // bv,
                         minlength=nb * nb).reshape(nb, nb)
    for b in range(nb):
        lone = np.flatnonzero(counts[b] % te == 1)
        full = np.flatnonzero((counts[b] % te == 0) & (counts[b] > 0))
        if lone.size and full.size:
            e = np.flatnonzero((src // bv == b) & (dst // bv == lone[0]))[0]
            u = int(src[np.flatnonzero(src // bv == b)[0]])
            v = int(full[0]) * bv
            return EdgeDelta(remove=[(int(src[e]), int(dst[e]))],
                             add=[(u, v, 1.5)], symmetrize=False)
    return None


@pytest.mark.parametrize("geom", [(64, 8), (32, 4)])
def test_patch_blocked_rebuckets_a_slab_in_place(geom):
    bv, te = geom
    found = 0
    for name in NAMES:
        hg = _case(name)["hg"]
        delta = _rebucket_delta(hg, bv, te)
        if delta is None:
            continue
        layout = build_blocked(hg, device="cpu", block_v=bv, tile_e=te)
        old = dict(src=layout.src.data_ptr(),
                   tile_dst=layout.tile_dst.tolist(), slab=layout.slab_ptr)
        new, new_host, _ = patch_blocked(layout, delta, host=hg)
        assert_layout_equal(build_blocked(new_host, device="cpu",
                                          block_v=bv, tile_e=te), new, name)
        assert _branch(old, new) == "slab re-bucketed", name
        found += 1
    assert found >= 2, geom


def test_patch_blocked_with_shares_one_host_patch():
    """One ``patch_host`` serves the blocked layout and the shards, and a
    patch whose edits change no weight leaves the layout's data as it
    was."""
    c = _case("gr_16")
    new_host, applied = patch_host(c["hg"], c["delta"])
    layout = build_blocked(c["hg"], device="cpu", block_v=64, tile_e=64)
    got = patch_blocked_with(layout, c["hg"], new_host, applied)
    assert_layout_equal(build_blocked(new_host, device="cpu", block_v=64,
                                      tile_e=64), got, "with")
    sg = patch_sharded_with(tdistributed.shard_graph(c["hg"], 4), new_host,
                            applied)
    assert np.array_equal(sg.deg.reshape(-1)[:c["hg"].n], new_host.deg)
    e = unique_undirected(c["rg"])[0]
    u, v = int(c["rg"].src[e]), int(c["rg"].dst[e])
    same = EdgeDelta(reweight=[(u, v, float(np.float32(c["rg"].w[e])))])
    layout = build_blocked(c["hg"], device="cpu", block_v=64, tile_e=64)
    keep = build_blocked(c["hg"], device="cpu", block_v=64, tile_e=64)
    got, host2, _ = patch_blocked(layout, same, host=c["hg"])
    # the same arrays; max_w is now the f32 weight's value, as in the
    # reference's patch_host
    assert_host_equal(dataclasses.replace(
        c["hg"], max_w=float(np.float32(c["hg"].max_w))), host2, "same")
    assert_layout_equal(keep, got, "same")
    with pytest.raises(ValueError, match="n="):
        patch_blocked_with(build_blocked(port_host(rgen.road_grid(12)),
                                         device="cpu"),
                           c["hg"], new_host, applied)


# ---------------------------------------------------------------------------
# (c) repair_state and repair, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_repair_state_matches_reference(name):
    c = _case(name)
    new_host, applied = patch_host(c["hg"], c["delta"])
    want = rdelta.repair_state(c["rnew"], c["d0"], c["p0"], c["rapplied"])
    got = repair_state(new_host, torch.from_numpy(c["d0"].copy()),
                       torch.from_numpy(c["p0"].copy()), applied)
    for a, b in zip(want[:3], got[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert dataclasses.asdict(want[3]) == dataclasses.asdict(got[3]), name


# (backend, fused_rounds, layout geometry)
REPAIRS = {"segment_min": ("segment_min", 0), "blocked": ("blocked", 0),
           "fused": ("blocked", 4)}


@functools.lru_cache(maxsize=None)
def _port_repair(name, how):
    c = _case(name)
    backend, fused = REPAIRS[how]
    new_host, applied = patch_host(c["hg"], c["delta"])
    d0, p0, _ = sssp(c["hg"], c["src"], device="cpu")
    layout = new_host.to_device("cpu") if backend == "segment_min" \
        else build_blocked(new_host, device="cpu")
    out = repair(layout, new_host, d0, p0, applied, backend=backend,
                 fused_rounds=fused)
    return out, (d0, p0), new_host


@pytest.mark.parametrize("how", list(REPAIRS))
@pytest.mark.parametrize("name", NAMES)
def test_repair_matches_reference(name, how):
    c = _case(name)
    out, (d0, p0), _ = _port_repair(name, how)
    assert d0.numpy().tobytes() == c["d0"].tobytes(), name
    assert p0.numpy().tobytes() == c["p0"].tobytes(), name
    assert_repair_equal(c["rep"], out, f"{name}/{how}")
    assert dataclasses.asdict(out[3]) == dataclasses.asdict(c["rep"][3])
    assert metrics_dict(out[2])["n_steps"] == 0


@pytest.mark.parametrize("name", NAMES)
def test_repair_equals_from_scratch(name):
    """The port's from-scratch solve of the patched graph (bitwise the
    reference's by ``test_torch_sssp.py``) against every repair, where it
    matches Dijkstra."""
    c = _case(name)
    new_host, _ = patch_host(c["hg"], c["delta"])
    scratch = sssp(new_host, c["src"], device="cpu")
    if not matches_dijkstra(new_host, scratch[0], c["src"]):
        pytest.xfail("the from-scratch solve misses Dijkstra on this "
                     "graph (ROADMAP queue 3 item 1)")
    scratch = tuple(x.numpy() for x in scratch[:2]) + (scratch[2],)
    for how in REPAIRS:
        out, _, _ = _port_repair(name, how)
        assert_repair_equal(scratch, out, f"{name}/{how}", counters=False)


def test_repair_against_the_reference_pallas_kernel():
    """One graph through the reference's ``blocked`` repair (its Pallas
    kernel in interpret mode) and the fused one."""
    c = _case("gr_4")
    rlay = ref_prepare(c["rnew"].to_device(), "blocked")
    for fused, how in ((0, "blocked"), (4, "fused")):
        want = rdelta.repair(rlay, c["rnew"], c["d0"], c["p0"],
                             c["rapplied"], backend="blocked",
                             fused_rounds=fused)
        got, _, _ = _port_repair("gr_4", how)
        assert_repair_equal(want, got, how)


def test_seeded_sweep_of_random_edit_batches():
    rg, hg = _graphs()["gr_8"]
    src = int(np.argmax(rg.deg))
    d0r, p0r, _ = ref_sssp(rg.to_device(), src)
    d0, p0, _ = sssp(hg, src, device="cpu")
    for i in range(6):
        rng = np.random.default_rng(100 + i)
        rd = make_delta(rg, rng, n_edits=int(rng.integers(1, 14)),
                        add=bool(i % 2))
        rnew, rapplied = rdelta.patch_host(rg, rd)
        new_host, applied = patch_host(hg, port_delta(rd))
        assert_host_equal(rnew, new_host, f"sweep {i}")
        want = rdelta.repair(rnew.to_device(), rnew, d0r, p0r, rapplied)
        for backend, fused in REPAIRS.values():
            layout = new_host.to_device("cpu") if backend == "segment_min" \
                else build_blocked(new_host, device="cpu", block_v=64,
                                   tile_e=64)
            got = repair(layout, new_host, d0, p0, applied, backend=backend,
                         fused_rounds=fused)
            assert_repair_equal(want, got, f"sweep {i}/{backend}/{fused}")


@pytest.mark.parametrize("maker,kw", [
    ("kronecker", dict(scale=9, edge_factor=8, seed=2)),
    ("road_grid", dict(side=24, seed=5))])
def test_decrease_only_takes_the_fast_path(maker, kw):
    rg = getattr(rgen, maker)(**kw)
    hg = port_host(rg)
    src = int(np.argmax(rg.deg))
    d0r, p0r, _ = ref_sssp(rg.to_device(), src)
    und = unique_undirected(rg)[:6]
    rd = rdelta.EdgeDelta(reweight=[
        (int(rg.src[e]), int(rg.dst[e]), float(np.float32(rg.w[e]) * 0.5))
        for e in und])
    rnew, rapplied = rdelta.patch_host(rg, rd)
    want = rdelta.repair(rnew.to_device(), rnew, d0r, p0r, rapplied)
    new_host, applied = patch_host(hg, port_delta(rd))
    assert applied.decrease_only and not applied.safe_stale
    d0, p0, _ = sssp(hg, src, device="cpu")
    for backend, fused in REPAIRS.values():
        layout = new_host.to_device("cpu") if backend == "segment_min" \
            else build_blocked(new_host, device="cpu")
        got = repair(layout, new_host, d0, p0, applied, backend=backend,
                     fused_rounds=fused)
        assert got[3].fast_path and got[3].n_invalid == 0
        assert_repair_equal(want, got, f"{maker}/{backend}/{fused}")


def test_non_tree_edit_invalidates_nothing():
    rg = rgen.road_grid(16, seed=5)
    hg = port_host(rg)
    src = int(np.argmax(rg.deg))
    d0, p0, _ = sssp(hg, src, device="cpu")
    par = p0.numpy()
    for e in unique_undirected(rg):
        u, v = int(rg.src[e]), int(rg.dst[e])
        if par[v] != u and par[u] != v:
            break
    new_host, applied = patch_host(hg, EdgeDelta(remove=[(u, v)]))
    _, _, frontier, st = repair_state(new_host, d0, p0, applied)
    assert st.n_invalid == 0 and not st.fast_path
    got = repair(new_host.to_device("cpu"), new_host, d0, p0, applied)
    scratch = sssp(new_host, src, device="cpu")
    assert_repair_equal(scratch, got, "non-tree", counters=False)
    assert torch.equal(got[0], d0) and torch.equal(got[1], p0)


def test_repair_relax_options():
    c = _case("gr_4")
    g = c["hg"].to_device("cpu")
    d = torch.full((g.n,), float("inf"))
    with pytest.raises(ConfigError, match="blocked layout"):
        repair_relax(g, d, torch.full((g.n,), -1, dtype=torch.int32),
                     torch.zeros(g.n, dtype=torch.bool), fused_rounds=4)
    with pytest.raises(ValueError, match="shapes disagree"):
        repair_relax(g, d, torch.zeros(3, dtype=torch.int32),
                     torch.zeros(g.n, dtype=torch.bool))
    # an empty frontier is already a fixpoint: no round, one read
    out = repair_relax(g, d, torch.full((g.n,), -1, dtype=torch.int32),
                       torch.zeros(g.n, dtype=torch.bool))
    m = metrics_dict(out[2])
    assert m["n_rounds"] == 0 and m["n_host_syncs"] == 1.0


def test_single_tier_apply_delta_raises_config_error():
    s = Solver.open(_case("gr_4")["hg"], device="cpu")
    with pytest.raises(ConfigError, match="routed tier"):
        s.apply_delta(EdgeDelta())
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.apply_delta(EdgeDelta())


# ---------------------------------------------------------------------------
# (d) repair_distributed, at 1 rank in process and at 2 and 4 ranks
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_one(tmp_path):
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    yield
    tdist.destroy_process_group()


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
@pytest.mark.parametrize("name", ["gr_8", "Road"])
def test_repair_distributed_at_one_rank(name, backend, gloo_one):
    c = _case(name)
    sg, new_host, applied = patch_sharded(
        tdistributed.shard_graph(c["hg"], 1), c["delta"], host=c["hg"])
    d_i, p_i, front, _ = repair_state(new_host, c["d0"], c["p0"], applied)
    out = tdistributed.repair_distributed(
        sg, d_i, p_i, front, version="v1", backend=backend, device="cpu",
        **({} if backend == "segment_min" else dict(block_v=64, tile_e=64)))
    n = c["hg"].n
    assert_repair_equal(c["rep"], (out[0][:n], out[1][:n], out[2]), name)
    # v2 (the default, the reference's) and v3 repair through their
    # exchanges, to the same state and counters
    geom = {} if backend == "segment_min" else dict(block_v=64, tile_e=64)
    for version in ("v2", "v3"):
        out = tdistributed.repair_distributed(
            sg, d_i, p_i, front, backend=backend, device="cpu", **geom,
            **({} if version == "v2" else dict(version=version)))
        assert_repair_equal(c["rep"], (out[0][:n], out[1][:n], out[2]),
                            f"{name} {version}")
    # the patched graph's batch: each slot its scalar solve
    batch = tdistributed.sssp_distributed_batch(sg, [c["src"], 0],
                                                device="cpu")
    for i, s in enumerate((c["src"], 0)):
        one = tdistributed.sssp_distributed(sg, s, device="cpu")
        assert batch[0][i].view(torch.int32).equal(one[0].view(torch.int32))
        assert batch[1][i].equal(one[1])
        assert all(a[i].equal(b) for a, b in zip(batch[2], one[2]))


_CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as tdist
from repro_torch.core.distributed import repair_distributed, shard_graph
from repro_torch.core.sssp import metrics_dict
from repro_torch.delta import EdgeDelta, patch_host, patch_sharded_with, \
    repair_state
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
with open(sys.argv[5]) as f:
    case = json.load(f)
torch.set_num_threads(1)
tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                         rank=rank, world_size=world)
res = {}
for name, c in case.items():
    from repro_torch.core.graph import HostGraph
    hg = HostGraph(n=c["n"], max_w=c["max_w"],
                   **{k: np.asarray(v, dtype) for k, (v, dtype) in
                      c["arrays"].items()})
    delta = EdgeDelta(**{k: [tuple(r) for r in v]
                         for k, v in c["delta"].items()})
    new_host, applied = patch_host(hg, delta)
    sg = patch_sharded_with(shard_graph(hg, world), new_host, applied)
    d_i, p_i, front, _ = repair_state(new_host, np.asarray(c["d0"],
                                                           np.float32),
                                      np.asarray(c["p0"], np.int32), applied)
    for version in ("v1", "v2", "v3"):
        for backend in ("segment_min", "blocked"):
            opts = {} if backend == "segment_min" else dict(block_v=64,
                                                            tile_e=64)
            d, p, m = repair_distributed(sg, d_i, p_i, front,
                                         version=version, backend=backend,
                                         device="cpu", **opts)
            key = name + ("" if version == "v1" else "/" + version)
            res[key + "/" + backend] = dict(
                dist=d[:hg.n].view(torch.int32).tolist(),
                parent=p[:hg.n].tolist(), metrics=metrics_dict(m))
tdist.destroy_process_group()
with open(out + "." + str(rank), "w") as f:
    json.dump(res, f)
"""

CHILD_GRAPHS = ["gr_8", "Road"]


def _child_case() -> dict:
    out = {}
    for name in CHILD_GRAPHS:
        c = _case(name)
        hg = c["hg"]
        out[name] = dict(
            n=hg.n, max_w=hg.max_w,
            arrays={f: (np.asarray(getattr(hg, f)).tolist(),
                        str(np.asarray(getattr(hg, f)).dtype))
                    for f in HOST_FIELDS},
            delta=dict(add=[list(r) for r in zip(*(a.tolist()
                                                   for a in c["rd"].add))],
                       remove=[list(r) for r in zip(*(
                           a.tolist() for a in c["rd"].remove))],
                       reweight=[list(r) for r in zip(*(
                           a.tolist() for a in c["rd"].reweight))]),
            d0=c["d0"].tolist(), p0=c["p0"].tolist())
    return out


def _run_ranks(world: int, tmp: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = tmp / "result"
    case = tmp / "case.json"
    case.write_text(json.dumps(_child_case()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(rank), str(world),
         str(tmp / "store"), str(out), str(case)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        for rank, proc in enumerate(procs):
            try:
                _, err = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} of {world} did not finish in "
                            f"{CHILD_TIMEOUT_S} s")
            assert proc.returncode == 0, f"rank {rank}: {err[-3000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [json.loads(Path(f"{out}.{rank}").read_text())
            for rank in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = {}

    def results(world):
        if world not in cache:
            cache[world] = _run_ranks(world,
                                      tmp_path_factory.mktemp(f"p{world}"))
        return cache[world]
    return results


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
@pytest.mark.parametrize("name", CHILD_GRAPHS)
@pytest.mark.parametrize("world", [2, 4])
def test_repair_distributed_over_ranks(world, name, backend, ranks):
    every = ranks(world)
    got = every[0][f"{name}/{backend}"]
    for other in every[1:]:
        assert other[f"{name}/{backend}"] == got      # replicated
    rd_, rp_, rm = _case(name)["rep"][:3]
    assert np.asarray(rd_).view(np.int32).tolist() == got["dist"], name
    assert np.asarray(rp_).tolist() == got["parent"], name
    for f in LOGICAL_METRIC_FIELDS:
        assert int(getattr(rm, f)) == got["metrics"][f], (name, f)


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
@pytest.mark.parametrize("version", ["v2", "v3"])
@pytest.mark.parametrize("name", CHILD_GRAPHS)
@pytest.mark.parametrize("world", [2, 4])
def test_repair_distributed_v2_v3_over_ranks(world, name, version, backend,
                                             ranks):
    """The v2/v3 repairs over 2 and 4 ranks, each rank holding its block,
    bitwise the reference's single-device repair."""
    key = f"{name}/{version}/{backend}"
    every = ranks(world)
    got = every[0][key]
    for other in every[1:]:
        assert other[key] == got      # gathered on every rank
    rd_, rp_, rm = _case(name)["rep"][:3]
    assert np.asarray(rd_).view(np.int32).tolist() == got["dist"], key
    assert np.asarray(rp_).tolist() == got["parent"], key
    for f in LOGICAL_METRIC_FIELDS:
        assert int(getattr(rm, f)) == got["metrics"][f], (key, f)


# ---------------------------------------------------------------------------
# (e) stale landmark sets
# ---------------------------------------------------------------------------

def test_stale_landmarks_give_forward_only_bounds(tmp_path):
    """A set kept across an increase/remove-only delta is marked stale:
    ``sym`` drops to 0 (forward-only bounds, no seeded upper bound), and
    its p2p queries on the patched graph are bitwise the reference's
    (dist[t], the path and the counters)."""
    rg = rgen.kronecker(9, 8, seed=2)
    hg = port_host(rg)
    und = unique_undirected(rg)
    rd = rdelta.EdgeDelta(
        remove=[(int(rg.src[e]), int(rg.dst[e])) for e in und[:4]],
        reweight=[(int(rg.src[e]), int(rg.dst[e]),
                   float(np.float32(rg.w[e]) * 1.4)) for e in und[4:8]])
    rnew, _ = rdelta.patch_host(rg, rd)
    new_host, applied = patch_host(hg, port_delta(rd))
    assert applied.safe_stale
    rset = rlm.build_landmarks(rg.to_device(), n_landmarks=4)
    rstale = dataclasses.replace(rset, stale=True, generation=3)
    lm = convert.landmarks_from_reference(lm_arrays(rset), "cpu")
    assert (lm.generation, lm.stale) == (-1, False)
    stale = dataclasses.replace(lm, stale=True, generation=3)
    assert float(stale.alt_data.sym) == 0.0
    assert float(lm.alt_data.sym) == float(rset.alt_data.sym)
    src = int(np.argmax(rg.deg))
    for t in (int(x) for x in np.random.default_rng(7).choice(
            rg.n, 3, replace=False)):
        want = ref_sssp(rnew.to_device(), src, goal="p2p", goal_param=t,
                        landmarks=rstale)
        got = sssp(new_host, src, goal="p2p", goal_param=t, landmarks=stale,
                   device="cpu")
        assert np.asarray(want[0])[t:t + 1].tobytes() == \
            got[0][t:t + 1].numpy().tobytes(), t
        assert reconstruct_path(np.asarray(want[1]), src, t) == \
            reconstruct_path(got[1].numpy(), src, t), t
        for f in LOGICAL_METRIC_FIELDS:
            assert int(getattr(want[2], f)) == metrics_dict(got[2])[f], f
    # a saved set loads unmanaged and fresh
    save(stale, tmp_path / "lm.npz")
    back = load(tmp_path / "lm.npz", device="cpu")
    assert (back.generation, back.stale) == (-1, False)
    assert build_landmarks(hg, 2, device="cpu").generation == -1
