"""Port parity: graph containers, generators and the blocked layout.

For the same seeds, every host and layout array of ``repro_torch`` must
equal the reference's (``repro``), including empty buckets, all-padding
slabs and the tile padding; ``convert.from_reference`` must carry a
reference layout into the port unchanged.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as rgraph
import repro.data.generators as rgen
from repro_torch import convert
from repro_torch.core import graph as tgraph
from repro_torch.data import generators as tgen
from release_xla import release_compiled  # noqa: F401

GENERATED = [
    ("kronecker", dict(scale=9, edge_factor=8, seed=1)),
    ("kronecker", dict(scale=7, edge_factor=4, seed=3, weights="bimodal")),
    ("uniform_random", dict(n=700, m=3000, seed=2)),
    ("road_grid", dict(side=20, seed=4)),
    ("road_grid", dict(side=9, seed=6, diag=True)),
]
HOST_FIELDS = ("src", "dst", "w", "row_ptr", "deg", "rtow")
SLAB_FIELDS = ("src_local", "dst", "w", "tile_dst", "tile_first",
               "bucket_nonempty")


def ref_arrays(obj) -> dict:
    """Flatten a reference HostGraph / DeviceGraph / BlockedGraph into the
    numpy dict that ``convert.from_reference`` takes."""
    if isinstance(obj, rgraph.BlockedGraph):
        out = {k: getattr(obj, k) for k in (
            "n", "block_v", "n_blocks", "n_dst_blocks", "src_base", "tile_e",
            "dense_grid_tiles")}
        out["deg"] = np.asarray(obj.deg)
        for i, slab in enumerate(obj.slabs):
            for f in SLAB_FIELDS:
                out[f"slabs/{i}/{f}"] = np.asarray(getattr(slab, f))
        return out
    if isinstance(obj, rgraph.DeviceGraph):
        return {k: np.asarray(v) for k, v in obj._asdict().items()}
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _random_graph(seed, n, m, lo_frac=1.0):
    """Random multigraph whose sources avoid the top of the id range when
    ``lo_frac < 1`` (so the last source blocks have no edges)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, max(int(n * lo_frac), 2), m)
    v = rng.integers(0, n, m)
    keep = u != v
    w = rng.random(keep.sum()) + 1e-3
    return (rgraph.build_csr(n, u[keep], v[keep], w),
            tgraph.build_csr(n, u[keep], v[keep], w))


@pytest.mark.parametrize("name,kwargs", GENERATED)
def test_generators_match_reference(name, kwargs):
    rg = getattr(rgen, name)(**kwargs)
    tg = getattr(tgen, name)(**kwargs)
    assert rg.n == tg.n and rg.max_w == tg.max_w
    for f in HOST_FIELDS:
        a, b = getattr(rg, f), getattr(tg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_to_device_matches_reference():
    rg = rgen.kronecker(8, 8, seed=5)
    tg = tgen.kronecker(8, 8, seed=5)
    rd = rg.to_device()
    td = tg.to_device("cpu")
    for f in rgraph.DeviceGraph._fields:
        np.testing.assert_array_equal(np.asarray(getattr(rd, f)),
                                      getattr(td, f).numpy(), err_msg=f)
    assert td.src.dtype == torch.int64 and td.deg.dtype == torch.int32
    assert (td.n, td.m) == (rd.n, rd.m)
    # the converted reference DeviceGraph is the port's own
    cd = convert.from_reference(ref_arrays(rd), "cpu")
    for f in tgraph.DeviceGraph._fields:
        a, b = getattr(cd, f), getattr(td, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("n_dst_blocks,block_v,tile_e,m", [
    (4, 4, 4, 6), (5, 16, 8, 40), (3, 32, 16, 0), (8, 8, 4, 200)])
def test_bucket_edges_matches_reference(n_dst_blocks, block_v, tile_e, m):
    rng = np.random.default_rng(m + block_v)
    # only even destination blocks receive edges: odd buckets stay empty
    dst = (rng.integers(0, (n_dst_blocks + 1) // 2, m) * 2 * block_v
           + rng.integers(0, block_v, m)).astype(np.int32)
    src = rng.integers(0, block_v, m).astype(np.int32)
    w = rng.random(m).astype(np.float32)
    ref = rgraph.bucket_edges(src, dst, w, n_dst_blocks=n_dst_blocks,
                              block_v=block_v, tile_e=tile_e)
    out = tgraph.bucket_edges(src, dst, w, n_dst_blocks=n_dst_blocks,
                              block_v=block_v, tile_e=tile_e)
    for i, (a, b) in enumerate(zip(ref, out)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))


def test_bucket_edges_rejects_out_of_range_dst():
    with pytest.raises(ValueError, match="destination range"):
        tgraph.bucket_edges(np.zeros(1), np.array([9]), np.ones(1),
                            n_dst_blocks=2, block_v=4, tile_e=4)


@pytest.mark.parametrize("seed,n,m,lo_frac,block_v,tile_e", [
    (0, 300, 1500, 1.0, 128, 128),
    (1, 300, 900, 0.3, 64, 32),       # last source blocks: no edges
    (2, 130, 0, 1.0, 64, 64),         # no edges at all
    (3, 1000, 8000, 1.0, 256, 64),
])
def test_build_blocked_matches_reference(seed, n, m, lo_frac, block_v,
                                         tile_e):
    rg, tg = _random_graph(seed, n, m, lo_frac)
    rb = rgraph.build_blocked(rg, block_v=block_v, tile_e=tile_e)
    tb = tgraph.build_blocked(tg, block_v=block_v, tile_e=tile_e,
                              device="cpu")
    for f in ("n", "block_v", "n_blocks", "n_dst_blocks", "tile_e",
              "dense_grid_tiles", "n_pad", "n_out"):
        assert getattr(rb, f) == getattr(tb, f), f
    np.testing.assert_array_equal(np.asarray(rb.deg), tb.deg.numpy())
    assert len(tb.slab_ptr) == rb.n_blocks + 1
    for b, rs in enumerate(rb.slabs):
        ts = tb.slab(b)
        for f in SLAB_FIELDS:
            a, c = np.asarray(getattr(rs, f)), getattr(ts, f).numpy()
            assert a.dtype == c.dtype, f
            np.testing.assert_array_equal(a, c, err_msg=f"slab {b} {f}")
    # the reference layout carried over is the port's own
    cb = convert.from_reference(ref_arrays(rb), "cpu")
    assert cb.slab_ptr == tb.slab_ptr
    for f in ("src", "dst", "w", "tile_dst", "tile_first", "bucket_nonempty",
              "deg"):
        assert torch.equal(getattr(cb, f), getattr(tb, f)), f


def test_build_blocked_from_device_graph():
    rg, tg = _random_graph(4, 200, 800)
    on_host = tgraph.build_blocked(tg, block_v=64, tile_e=32, device="cpu")
    on_dev = tgraph.build_blocked(tg.to_device("cpu"), block_v=64, tile_e=32)
    for f in ("src", "dst", "w", "tile_dst", "tile_first"):
        assert torch.equal(getattr(on_host, f), getattr(on_dev, f)), f
    with pytest.raises(ValueError, match="device="):
        tgraph.build_blocked(tg)


def test_default_geometry():
    rg, tg = _random_graph(5, 1500, 6000)
    # on the CPU: the reference's own defaults and layout
    rb = rgraph.build_blocked(rg)
    tb = tgraph.build_blocked(tg, device="cpu")
    assert (tb.block_v, tb.tile_e, tb.dense_grid_tiles) == \
        (rb.block_v, rb.tile_e, rb.dense_grid_tiles)
    # for the card: one block over every vertex, padded by under a tile
    block_v, tile_e = tgraph.default_geometry(tg.n, "cuda")
    assert (block_v, tile_e) == (1536, tgraph.CUDA_TILE_E)
    assert tgraph.default_geometry(1 << 20, "cuda") == (1 << 20, 256)
    cb = tgraph.build_blocked(tg, block_v=block_v, tile_e=tile_e,
                              device="cpu")
    assert cb.n_blocks == 1 and cb.n_out >= tg.n
    assert 0 <= cb.src.shape[0] - tg.m < tile_e
    # one bucket in CSR order: the slab is the flat edge list, then padding
    assert torch.equal(cb.src[:tg.m], torch.from_numpy(tg.src))
    assert torch.equal(cb.dst[:tg.m], torch.from_numpy(tg.dst))


def test_convert_host_graph():
    rg = rgen.road_grid(6, seed=1)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    assert isinstance(hg, tgraph.HostGraph)
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(rg, f), getattr(hg, f))
    assert hg.max_w == rg.max_w and hg.n == rg.n


def test_degree_bucket_matches_reference():
    # every degree up to 2^17, and the neighbourhood of every power of two
    # up to 2^30, where float32 log2 rounding decides the bucket
    deg = np.arange(0, 1 << 17, dtype=np.int32)
    pw = np.array([(1 << k) + d for k in range(17, 31)
                   for d in (-2, -1, 0, 1)], np.int64)
    deg = np.concatenate([deg, pw.astype(np.int32)])
    ref = np.asarray(rgraph.degree_bucket(jnp.asarray(deg)))
    out = tgraph.degree_bucket(torch.from_numpy(deg)).numpy()
    np.testing.assert_array_equal(ref, out)
    np.testing.assert_array_equal(rgraph.degree_bucket_np(deg),
                                  tgraph.degree_bucket_np(deg))
    np.testing.assert_array_equal(
        np.asarray(rgraph.bucket_representative()),
        tgraph.bucket_representative().numpy())
