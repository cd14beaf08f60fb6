"""Port parity: the edge_relax kernel's plain version and its wrapper.

On the CPU the wrapper ``relax_bucket`` runs the plain PyTorch version;
it must be bitwise equal to the reference Pallas kernel run in interpret
mode on the same slabs (values, winners and the active-tile count, the
third of the counters it returns), and the port's ``schedule_tiles`` to
the reference's.  The CUDA kernel
itself is held against the plain version by ``tests/test_torch_cuda.py``
(on the card only; that file imports no jax) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import bucket_edges as ref_bucket_edges
from repro.kernels.edge_relax.edge_relax import (edge_relax as ref_kernel,
                                                 schedule_tiles as ref_sched)
from repro_torch.core.graph import build_blocked, build_csr
from repro_torch.kernels.edge_relax import ops, ref
from release_xla import release_compiled  # noqa: F401

BV = TE = 128


def _slab(seed, *, n_src, n_dst_blocks, m, ties=False, empty_every=0):
    """A random reference-bucketed slab plus a dist/frontier block."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, m).astype(np.int32)
    db = rng.integers(0, n_dst_blocks, m)
    if empty_every:
        db = db - db % empty_every            # only every k-th bucket used
    dst = (db * BV + rng.integers(0, BV, m)).astype(np.int32)
    w = (rng.integers(1, 4, m).astype(np.float32) if ties
         else (rng.random(m) + 1e-3).astype(np.float32))
    dist = (rng.integers(0, 5, n_src) if ties
            else rng.random(n_src) * 3).astype(np.float32)
    dist[rng.random(n_src) < 0.2] = np.inf
    front = ((rng.random(n_src) < 0.4) & np.isfinite(dist)).astype(np.int8)
    parent = np.where(np.isfinite(dist), rng.integers(0, n_dst_blocks * BV,
                                                      n_src), -1)
    slab = ref_bucket_edges(src, dst, w, n_dst_blocks=n_dst_blocks,
                            block_v=BV, tile_e=TE)
    return dist, front, parent.astype(np.int32), slab


CASES = [
    dict(seed=0, n_src=128, n_dst_blocks=3, m=700),
    dict(seed=1, n_src=128, n_dst_blocks=5, m=900, empty_every=2),
    dict(seed=2, n_src=128, n_dst_blocks=2, m=600, ties=True),
    dict(seed=3, n_src=128, n_dst_blocks=4, m=0),           # all padding
    dict(seed=4, n_src=128, n_dst_blocks=1, m=300, ties=True),
]
WINDOWS = [(0.0, np.inf), (1.0, 3.5)]      # lb <= 0 and a mid window


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c['seed']}")
@pytest.mark.parametrize("window", WINDOWS)
def test_relax_bucket_matches_reference_kernel(case, window):
    dist, front, parent, (se, de, we, td, tf, bne, _) = _slab(**case)
    lb, ub = np.float32(window[0]), np.float32(window[1])
    nb = case["n_dst_blocks"]
    rv, rw, rn = ref_kernel(
        jnp.asarray(dist), jnp.asarray(front), *map(jnp.asarray,
                                                    (se, de, we, td, tf, bne)),
        lb, ub, block_v=BV, tile_e=TE, n_dst_blocks=nb, interpret=True)
    t = torch.from_numpy
    vals, wins, counts = ops.relax_bucket(
        t(dist), t(front.astype(bool)), t(parent), t(se), t(de), t(we),
        t(tf), t(np.array(lb)), t(np.array(ub)), tile_e=TE, n_out=nb * BV)
    np.testing.assert_array_equal(np.asarray(rv).view(np.int32),
                                  vals.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(rw), wins.numpy())
    assert int(rn) == int(counts[2])


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: f"seed{c['seed']}")
def test_schedule_tiles_matches_reference(case):
    dist, front, _, (se, de, we, td, tf, bne, _) = _slab(**case)
    rs, rn = ref_sched(jnp.asarray(front), jnp.asarray(se), jnp.asarray(we),
                       jnp.asarray(tf), TE)
    ts, tn = ref.schedule_tiles(torch.from_numpy(front.astype(bool)),
                                torch.from_numpy(se), torch.from_numpy(we),
                                torch.from_numpy(tf), TE)
    np.testing.assert_array_equal(np.asarray(rs), ts.numpy())
    assert int(rn) == int(tn) and tn.dtype == torch.int32


def _layout_case(device):
    rng = np.random.default_rng(5)
    n, m = 900, 5000
    u = rng.integers(0, n // 2, m)               # upper blocks: no edges
    v = rng.integers(0, n, m)
    keep = u != v
    g = build_csr(n, u[keep], v[keep], rng.integers(1, 4, keep.sum()))
    bg = build_blocked(g, block_v=256, tile_e=64, device=device)
    dist = rng.integers(0, 5, bg.n_out).astype(np.float32)
    dist[rng.random(bg.n_out) < 0.2] = np.inf
    front = (rng.random(bg.n_out) < 0.3) & np.isfinite(dist)
    parent = np.where(np.isfinite(dist), rng.integers(0, bg.n_out, bg.n_out),
                      -1).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)
    f = lambda x: torch.full((), x, dtype=torch.float32, device=device)
    return (t(dist), t(front), t(parent), bg.src, bg.dst, bg.w,
            bg.tile_first, f(0.0), f(np.inf)), dict(tile_e=bg.tile_e,
                                                     n_out=bg.n_out,
                                                     index=bg.index)


def test_cpu_tensors_take_the_plain_version():
    args, kw = _layout_case("cpu")
    ops.LAUNCHES.reset()
    vals, wins, counts = ops.relax_bucket(*args, **kw)
    assert ops.LAUNCHES.edge_relax == 0
    dist, paths, _, src, dst, w, _, lb, ub = args
    pv, pw = ref.edge_relax_ref(dist, paths, src, dst, w, lb, ub,
                                n_out=kw["n_out"])
    assert torch.equal(vals, pv) and torch.equal(wins, pw)
    n = counts[2]
    assert counts.dtype == torch.int32 and 1 <= int(n) <= args[6].shape[0]


def test_other_devices_raise():
    args, kw = _layout_case("cpu")
    kw["index"] = kw["index"].to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.relax_bucket(*[a.to("meta") for a in args], **kw)


def test_relax_primitives_match_reference():
    from repro.core import relax as rrelax
    from repro_torch.core import relax as trelax
    rng = np.random.default_rng(9)
    n, m = 300, 2000
    vals = rng.integers(0, 4, (3, n)).astype(np.float32)
    vals[rng.random((3, n)) < 0.3] = np.inf
    wins = rng.integers(0, 1000, (3, n)).astype(np.int32)
    wins[np.isinf(vals)] = 2 ** 31 - 1
    rb, rw = rrelax.combine_block_partials(jnp.asarray(vals),
                                           jnp.asarray(wins))
    tb, tw = trelax.combine_block_partials(torch.from_numpy(vals),
                                           torch.from_numpy(wins))
    np.testing.assert_array_equal(np.asarray(rb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(rw), tw.numpy())

    cand = rng.integers(0, 5, m).astype(np.float32)
    mask = rng.random(m) < 0.6
    cand[~mask] = np.inf
    ids = rng.integers(0, n, m).astype(np.int32)
    seg = rng.integers(0, n - 20, m).astype(np.int32)   # empty segments
    rb, rw = rrelax.segment_min_with_winner(*map(jnp.asarray,
                                                 (cand, mask, ids, seg)), n)
    tb, tw = trelax.segment_min_with_winner(
        torch.from_numpy(cand), torch.from_numpy(mask),
        torch.from_numpy(ids).long(), torch.from_numpy(seg).long(), n)
    np.testing.assert_array_equal(np.asarray(rb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(rw), tw.numpy())
    assert tw.dtype == torch.int32

    dist = (rng.random(n) * 6).astype(np.float32)
    dist[rng.random(n) < 0.2] = np.inf
    deg = rng.integers(0, 4, n).astype(np.int32)
    front = rng.random(n) < 0.5
    f32 = np.float32
    t = lambda a: torch.from_numpy(np.asarray(a))
    np.testing.assert_array_equal(
        np.asarray(rrelax.window_frontier(dist, f32(2.0), f32(2.5),
                                          f32(3.5), f32(1.0))),
        trelax.window_frontier(t(dist), t(f32(2.0)), t(f32(2.5)),
                               t(f32(3.5)), t(f32(1.0))).numpy())
    np.testing.assert_array_equal(
        np.asarray(rrelax.leaf_pruned(front, dist, deg)),
        trelax.leaf_pruned(t(front), t(dist), t(deg)).numpy())
    np.testing.assert_array_equal(
        np.asarray(rrelax.settled_mask(dist, f32(3.0))),
        trelax.settled_mask(t(dist), t(f32(3.0))).numpy())
    assert trelax.available_backends() == ("blocked_pallas", "segment_min")
    assert trelax.get_backend("blocked").name == "blocked_pallas"
    with pytest.raises(ValueError, match="unknown relax backend"):
        trelax.get_backend("nope")
