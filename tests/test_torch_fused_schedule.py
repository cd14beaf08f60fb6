"""Port: the fused kernel's frontier-list design, written plainly.

``csrc/edge_relax_fused.cu`` lists the frontier once a call, schedules
each round's tiles from the layout's vertex->tile index (the forced
tiles, then the index entries of the round's path sources, each tile
once), lists the destinations it touches and commits over that list
only.  ``ref.edge_relax_fused_steps`` takes the same steps in plain torch.
Here it is held bit for bit (dist, parent, frontier and all eight
``FUSED_COUNTERS``) against the contract ``ref.edge_relax_fused_ref`` and
against the JAX package's ``edge_relax_fused`` (the Pallas kernel in
interpret mode) on byte-identical inputs: the port's layout tensors,
which ``tests/test_torch_fused.py`` holds equal to the reference's fused
slab.  Cases: road16 and kron8 on a multi-bucket and a one-bucket layout
and a graph with +inf edges, forced tiles, ``fused_rounds`` 1, 4 and 8,
``lb <= 0``, an empty frontier, every vertex on the frontier, a vertex
that improves in two consecutive rounds, and the ALT branch.  The CUDA
kernel is held against both on the card by ``tests/test_torch_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.generators as rgen
from repro.kernels.edge_relax.edge_relax import edge_relax_fused as jfused
from repro_torch import convert
from repro_torch.core.graph import build_blocked, build_csr, default_geometry
from repro_torch.kernels.edge_relax import ops, ref
from test_torch_graph import ref_arrays
from release_xla import release_compiled  # noqa: F401

GRAPHS = {
    "road16": lambda: convert.from_reference(
        ref_arrays(rgen.road_grid(16, seed=2)), "cpu"),
    "kron8": lambda: convert.from_reference(
        ref_arrays(rgen.kronecker(8, 8, seed=1)), "cpu"),
    "inf-edges": lambda: _inf_graph(),
}
# (block_v, tile_e): a multi-bucket layout, and one bucket (None: the
# card's block) of small tiles, so that a hub spans many
GEOMETRIES = [(64, 64), (None, 32)]
# frontier kind, fused_rounds, lb
CASES = [("mid", 1, 0.5), ("mid", 4, 0.5), ("mid", 8, 0.5), ("mid", 4, 0.0),
         ("empty", 8, 0.5), ("every", 4, 0.5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inf_graph():
    """A directed random graph with a tenth of its edges at +inf."""
    rng = np.random.default_rng(3)
    n, m = 300, 2400
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = u != v
    w = rng.integers(1, 4, keep.sum()).astype(np.float64)
    w[rng.random(w.size) < 0.1] = np.inf
    return build_csr(n, u[keep], v[keep], w, symmetrize=False)


@functools.lru_cache(maxsize=None)
def _layout(name, geom):
    g = GRAPHS[name]()
    block_v, tile_e = geom
    if block_v is None:
        block_v = default_geometry(g.n, "cuda")[0]
    return g, build_blocked(g, block_v=block_v, tile_e=tile_e, device="cpu")


def _state(g, bg, kind, seed):
    """dist, parent, frontier over ``[0, n_out)``: 30 seeded vertices
    reached, half of them on the frontier ("mid"); none on it ("empty");
    or every real vertex reached and every vertex on it ("every")."""
    rng = np.random.default_rng(seed)
    n_out = bg.n_out
    dist = np.full(n_out, np.inf, np.float32)
    if kind == "every":
        dist[:g.n] = rng.integers(0, 6, g.n)
        front = np.ones(n_out, bool)
    else:
        seeds = rng.choice(g.n, 30, replace=False)
        dist[seeds] = rng.uniform(0.0, 3.0, seeds.size)
        front = np.zeros(n_out, bool)
        if kind == "mid":
            front[seeds[:15]] = True
    parent = np.where(np.isfinite(dist), rng.integers(0, g.n, n_out),
                      -1).astype(np.int32)
    return dist, parent, front


def _all_agree(bg, dist, parent, front, lb, ub, alt=(), *, rounds):
    """The steps, the contract and the JAX kernel (interpret) on the same
    inputs: all bitwise equal.  Returns the counters by name and the
    output."""
    t = torch.from_numpy
    f32 = lambda x: t(np.array(x, np.float32))
    talt = ()
    if alt:
        alt_lb, prune_ub, infl, tgt = alt
        talt = (t(alt_lb), f32(prune_ub), f32(infl),
                t(np.array(tgt, np.int32)))
    args = (t(dist), t(parent), t(front), bg.deg, bg.src, bg.dst, bg.w,
            bg.tile_first, f32(lb), f32(ub), *talt)
    kw = dict(tile_e=bg.tile_e, fused_rounds=rounds)
    steps = ref.edge_relax_fused_steps(*args, **kw, index=bg.index)
    plain = ref.edge_relax_fused_ref(*args, **kw)
    assert steps[0].dtype == torch.float32 and steps[2].dtype == torch.bool
    assert torch.equal(steps[0].view(torch.int32),
                       plain[0].view(torch.int32))
    for a, b in zip(steps[1:], plain[1:]):
        assert torch.equal(a, b)
    n = lambda x: x.numpy()
    jalt = () if not alt else (jnp.asarray(alt[0]), np.float32(alt[1]),
                               np.float32(alt[2]), np.int32(alt[3]))
    jout = jfused(jnp.asarray(dist), jnp.asarray(parent), jnp.asarray(front),
                  n(bg.deg), n(bg.src), n(bg.dst), n(bg.w), n(bg.tile_dst),
                  n(bg.tile_first), np.float32(lb), np.float32(ub), *jalt,
                  block_v=bg.block_v, tile_e=bg.tile_e, fused_rounds=rounds,
                  interpret=True)
    want = (np.asarray(jout[0]).view(np.int32), np.asarray(jout[1]),
            np.asarray(jout[2]), np.asarray(jout[3]))
    got = (steps[0].numpy().view(np.int32), steps[1].numpy(),
           steps[2].numpy().astype(np.int32), steps[3].numpy())
    for a, b, what in zip(want, got, ("dist", "parent", "frontier",
                                      "counts")):
        np.testing.assert_array_equal(a, b, err_msg=what)
    return dict(zip(ops.FUSED_COUNTERS, steps[3].tolist())), steps


@pytest.mark.parametrize("kind,rounds,lb", CASES,
                         ids=[f"{k}-r{r}-lb{lb}" for k, r, lb in CASES])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_fused_steps_match_contract_and_reference(name, geom, kind, rounds,
                                                  lb):
    g, bg = _layout(name, geom)
    dist, parent, front = _state(g, bg, kind, seed=len(name) + rounds)
    cnt, _ = _all_agree(bg, dist, parent, front, lb, 9.0, rounds=rounds)
    assert 1 <= cnt["n_exec"] <= (1 if lb <= 0 else rounds)
    assert cnt["n_rounds"] == (0 if kind == "empty" else cnt["n_exec"])
    if kind == "empty":
        forced = int(bg.tile_first.sum())
        assert list(cnt.values()) == [0, 0, 0, 0, 0, forced, 1, 0]
    else:
        assert cnt["n_trav"] > 0


def test_fused_steps_vertex_improves_in_consecutive_rounds():
    # a -> v (5), b -> c (1), c -> v (1): v improves in round 0 (via a)
    # and again in round 1 (via c), while it is on round 1's frontier
    rng = np.random.default_rng(28)
    n = 400
    u, x = rng.integers(4, n, 1500), rng.integers(4, n, 1500)
    keep = u != x
    src = np.concatenate([[0, 1, 2], u[keep]])
    dst = np.concatenate([[3, 2, 3], x[keep]])
    w = np.concatenate([[5.0, 1.0, 1.0], rng.integers(1, 4, keep.sum())])
    bg = build_blocked(build_csr(n, src, dst, w), block_v=64, tile_e=32,
                       device="cpu")
    dist = np.full(bg.n_out, np.inf, np.float32)
    dist[[0, 1]] = 0.0               # sources of degree 1: on a path
    front = np.zeros(bg.n_out, bool)
    front[[0, 1]] = True
    parent = np.full(bg.n_out, -1, np.int32)
    _, one = _all_agree(bg, dist, parent, front, 0.5, 10.0, rounds=1)
    assert float(one[0][3]) == 5.0 and bool(one[2][3]) and int(one[1][3]) == 0
    cnt, out = _all_agree(bg, dist, parent, front, 0.5, 10.0, rounds=4)
    assert float(out[0][3]) == 2.0 and int(out[1][3]) == 2
    assert cnt["n_exec"] == 3 and cnt["n_updates"] == 3
    assert not out[2].any()          # the third round improved nothing


@pytest.mark.parametrize("case", ["mid", "inf", "below-all", "tightens"])
@pytest.mark.parametrize("name", ["road16", "kron8"])
def test_fused_steps_alt_branch(name, case):
    g, bg = _layout(name, (64, 64))
    dist, parent, front = _state(g, bg, "mid", seed=11)
    rng = np.random.default_rng(12)
    alt_lb = (rng.integers(0, 8, bg.n_out) / 4).astype(np.float32)
    alt_lb[(rng.random(bg.n_out) < 0.15)
           | (np.arange(bg.n_out) >= g.n)] = np.inf
    reached = np.isfinite(dist[:g.n])
    tgt = int(np.flatnonzero(~reached if case == "tightens" else reached)[3])
    prune_ub = {"mid": 4.0, "inf": np.inf, "below-all": 0.0,
                "tightens": np.inf}[case]
    infl = 1.0 + 4.0 * 2.0 ** -24 * 100
    cnt, out = _all_agree(bg, dist, parent, front, 0.5, 20.0,
                          (alt_lb, prune_ub, infl, tgt), rounds=6)
    if case == "below-all":
        assert cnt["n_relax"] == 0 and cnt["n_pruned"] > 0
    if case == "tightens":
        assert bool(torch.isfinite(out[0][tgt])) and cnt["n_exec"] > 1
