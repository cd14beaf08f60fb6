"""Port parity: ALT-pruned point-to-point queries.

Both packages prune with the same landmark matrix: the reference's
``LandmarkSet`` is carried across with ``convert.landmarks_from_reference``
(and the port's own build is held bitwise to the reference's).  On the
nine scale-8 benchmark graphs of ``tests/test_alt_p2p.py``, a p2p solve
with landmarks on the port's ``segment_min``, ``blocked`` and fused paths,
and the bidirectional solve, must give ``dist``, ``parent`` and the
logical counters (``n_pruned`` included) bitwise equal to the
reference's, and ``dist[t]`` and the path equal to the unpruned solve's.
The primitives (``alt_lower_bounds``, ``alt_seed_ub``, ``alt_prune``) are
held to the reference's compiled program bitwise, and the ALT branches of
the kernels' plain versions to the reference's Pallas kernels in
interpret mode and to its ``ref.py``.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import landmarks as rlm
from repro.core import relax as rrelax
from repro.core.config import EngineConfig
from repro.core.graph import build_blocked as ref_build_blocked
from repro.core.graph import build_csr as ref_build_csr
from repro.core.sssp import sssp as ref_sssp
from repro.kernels.edge_relax import edge_relax as rker
from repro.kernels.edge_relax import ref as rref
from repro_torch import convert
from repro_torch.core import landmarks as tlm
from repro_torch.core import relax as trelax
from repro_torch.core.sssp import sssp
from repro_torch.kernels.edge_relax import ops, ref
from repro_torch.serve.queries import reconstruct_path
from test_alt_p2p import benchmark_graphs, pick_pair
from test_torch_edge_relax import BV, TE, _slab
from test_torch_graph import ref_arrays
from test_torch_sssp import BLOCKED, _np, _port, assert_same
from release_xla import release_compiled  # noqa: F401

GRAPHS = benchmark_graphs()
N_LANDMARKS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the solves here are many tiny ops: threads only add overhead
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lm_arrays(lm) -> dict:
    """A reference ``LandmarkSet`` flattened into its ``.npz`` fields."""
    return dict(landmarks=np.asarray(lm.landmarks), D=np.asarray(lm.D),
                strategy=lm.strategy, sym=lm.sym, max_hops=lm.max_hops)


@functools.lru_cache(maxsize=None)
def _case(name):
    """The graph in both packages, the pair ``tests/test_alt_p2p.py``
    picks for it, and the reference's landmark set in both."""
    rg = GRAPHS[name]
    dg = rg.to_device()
    s, t = pick_pair(rg, seed=zlib.crc32(name.encode()) % 1000)
    rset = rlm.build_landmarks(dg, n_landmarks=N_LANDMARKS,
                               strategy="farthest")
    return (rg, dg, convert.from_reference(ref_arrays(rg), "cpu"), s, t,
            rset, convert.landmarks_from_reference(lm_arrays(rset), "cpu"))


def assert_p2p_identical(a, b, s, t, label):
    """The ALT contract: d(s, t) bitwise and the same path."""
    assert a[0][t].tobytes() == b[0][t].tobytes(), label
    assert reconstruct_path(a[1], s, t) == reconstruct_path(b[1], s, t), \
        label


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _landmark_matrix(seed, L, n):
    """Seeded landmark distances with unreached entries: whole columns
    (both sides inf), single entries (one side inf) and, with several
    landmarks, one that reaches nothing but itself."""
    rng = np.random.default_rng(seed)
    D = (rng.random((L, n)) * 50).astype(np.float32)
    D[rng.random((L, n)) < 0.1] = np.inf
    D[:, rng.choice(n, 40, replace=False)] = np.inf
    if L > 1:
        D[L - 1, :] = np.inf
        D[L - 1, 7] = 0.0
    return D


@pytest.mark.parametrize("shape", [(6, 4000), (1, 40000)],
                         ids=["6x4000", "1x40000"])
@pytest.mark.parametrize("sym", [1.0, 0.0], ids=["sym", "directed"])
def test_alt_primitives_match_reference(sym, shape):
    # one landmark leaves no max over landmarks to hide a deflation that
    # rounds differently: the reference's compiled program fuses
    # diff - delta * (D + Dt) into one multiply-add, and a two-rounding
    # evaluation differs from it on tens of these entries
    D = _landmark_matrix(0, *shape)
    delta = np.float32(rlm._EPS * (2 * 37 + 64.0))
    infl = np.float32(1.0 + 4.0 * delta)
    lower = jax.jit(rrelax.alt_lower_bounds)     # as the solve runs it
    seed_ub = jax.jit(rrelax.alt_seed_ub)
    Dt = torch.from_numpy(D)
    f32 = lambda x: torch.tensor(np.float32(x))
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    cols_inf = np.where(~np.isfinite(D).any(axis=0))[0]
    for t in (0, 7, int(cols_inf[0]), shape[1] - 1):
        want = np.asarray(lower(jnp.asarray(D), jnp.int32(t), delta,
                                jnp.float32(sym)))
        got = trelax.alt_lower_bounds(Dt, i32(t), f32(delta), f32(sym))
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.numpy().view(np.int32), err_msg=t)
        for s in (1, 7, int(cols_inf[1])):
            w = np.asarray(seed_ub(jnp.asarray(D), jnp.int32(s),
                                   jnp.int32(t), infl, jnp.float32(sym)))
            g = trelax.alt_seed_ub(Dt, i32(s), i32(t), f32(infl), f32(sym))
            assert w.tobytes() == g.numpy().tobytes(), (s, t)
    # the split of candidates, inactive lanes and ties at the bound included
    rng = np.random.default_rng(1)
    cand = (rng.integers(0, 8, 500) / 2).astype(np.float32)
    active = rng.random(500) < 0.7
    cand[~active] = np.inf
    lb_dst = (rng.integers(0, 6, 500) / 4).astype(np.float32)
    lb_dst[rng.random(500) < 0.1] = np.inf
    for bound in (np.float32(2.5), np.float32(np.inf), np.float32(0.0)):
        kept, pruned = rrelax.alt_prune(jnp.asarray(cand),
                                        jnp.asarray(active),
                                        jnp.asarray(lb_dst), bound)
        k2, p2 = trelax.alt_prune(torch.from_numpy(cand),
                                  torch.from_numpy(active),
                                  torch.from_numpy(lb_dst), f32(bound))
        np.testing.assert_array_equal(np.asarray(kept), k2.numpy())
        np.testing.assert_array_equal(np.asarray(pruned), p2.numpy())


# ---------------------------------------------------------------------------
# landmark sets
# ---------------------------------------------------------------------------

def _directed_graph():
    """A directed (not symmetrized) random graph: ``sym`` is False."""
    rng = np.random.default_rng(3)
    n, m = 200, 1200
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = u != v
    return ref_build_csr(n, u[keep], v[keep],
                         rng.random(keep.sum()) + 1e-3, symmetrize=False)


SET_GRAPHS = {"gr_8": lambda: GRAPHS["gr_8"], "Road": lambda: GRAPHS["Road"],
              "directed": _directed_graph}


@pytest.mark.parametrize("strategy", ["farthest", "max_degree"])
@pytest.mark.parametrize("name", list(SET_GRAPHS))
def test_select_landmarks_matches_reference(name, strategy):
    rg = SET_GRAPHS[name]()
    args = (np.asarray(rg.row_ptr, np.int64), np.asarray(rg.dst, np.int64),
            np.asarray(rg.deg, np.int64), 6, strategy)
    want, want_h = rlm.select_landmarks(*args)
    got, got_h = tlm.select_landmarks(*args)
    np.testing.assert_array_equal(want, got)
    assert want_h == got_h


@pytest.mark.parametrize("name", list(SET_GRAPHS))
def test_build_landmarks_matches_reference(name):
    rg = SET_GRAPHS[name]()
    want = rlm.build_landmarks(rg.to_device(), n_landmarks=N_LANDMARKS)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    for kw in (dict(), dict(backend="segment_min", fused_rounds=0)):
        got = tlm.build_landmarks(hg, N_LANDMARKS, device="cpu", **kw)
        np.testing.assert_array_equal(np.asarray(want.landmarks),
                                      got.landmarks)
        np.testing.assert_array_equal(np.asarray(want.D).view(np.int32),
                                      got.D.numpy().view(np.int32))
        assert (got.sym, got.max_hops) == (want.sym, want.max_hops)
        assert got.sym == (name != "directed")
        assert got.delta == want.delta
        ad, rad = got.alt_data, want.alt_data
        assert float(ad.delta) == float(rad.delta)
        assert float(ad.sym) == float(rad.sym)
    with pytest.raises(ValueError, match="unknown landmark strategy"):
        tlm.build_landmarks(hg, 2, "random", device="cpu")


@pytest.mark.parametrize("seed", range(4))
def test_check_symmetric_matches_reference(seed):
    """The port's symmetry test (torch sorts) against the reference's
    ``np.lexsort`` test on seeded multigraphs: made symmetric, then with
    one reverse weight changed or one reverse edge dropped, and with
    -0.0 weights."""
    rng = np.random.default_rng(seed)
    verdicts = set()
    for case in range(40):
        n, m = int(rng.integers(2, 9)), int(rng.integers(1, 40))
        s, d = rng.integers(0, n, m), rng.integers(0, n, m)
        w = rng.integers(0, 3, m).astype(np.float32)
        s, d, w = np.r_[s, d], np.r_[d, s], np.r_[w, w]
        if case % 3 == 1:
            w[rng.integers(0, 2 * m)] += 1.0
        elif case % 3 == 2:
            keep = np.arange(2 * m) != rng.integers(0, 2 * m)
            s, d, w = s[keep], d[keep], w[keep]
        if case % 4 == 3:
            w[w == 0] = -0.0
        want = rlm._check_symmetric(s, d, w)
        got = tlm._check_symmetric(*map(torch.from_numpy, (s, d, w)))
        assert got == want, (case, s, d, w)
        verdicts.add(want)
    assert verdicts == {True, False}


def test_landmark_files_load_in_both_packages(tmp_path):
    _, dg, hg, *_, rset, _ = _case("Road")
    rlm.save(rset, tmp_path / "ref.npz")
    got = tlm.load(tmp_path / "ref.npz", device="cpu")
    tset = tlm.build_landmarks(hg, N_LANDMARKS, device="cpu")
    tlm.save(tset, tmp_path / "port.npz")
    back = rlm.load(tmp_path / "port.npz")
    for a, b in ((rset, got), (tset, back)):
        np.testing.assert_array_equal(np.asarray(a.landmarks),
                                      np.asarray(b.landmarks))
        np.testing.assert_array_equal(
            np.asarray(a.D.cpu() if isinstance(a.D, torch.Tensor) else a.D),
            np.asarray(b.D.cpu() if isinstance(b.D, torch.Tensor) else b.D))
        assert (a.strategy, a.sym, a.max_hops) == (b.strategy, b.sym,
                                                   b.max_hops)


# ---------------------------------------------------------------------------
# ALT p2p solves
# ---------------------------------------------------------------------------

PORT_BACKENDS = {"segment_min": {}, "blocked": dict(backend="blocked",
                                                   **BLOCKED),
                 "fused": dict(backend="blocked", fused_rounds=4, **BLOCKED)}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_alt_p2p_matches_reference(name):
    rg, dg, hg, s, t, rset, tset = _case(name)
    ref = _np(ref_sssp(dg, s, goal="p2p", goal_param=t, landmarks=rset))
    plain = _port(sssp(hg, s, device="cpu", goal="p2p", goal_param=t))
    assert plain[2]["n_pruned"] == 0
    for be, opts in PORT_BACKENDS.items():
        opts = dict(opts)
        out = _port(sssp(hg, s, device="cpu", goal="p2p", goal_param=t,
                         landmarks=tset, backend=opts.pop("backend", be),
                         **opts))
        assert_same(ref, out, f"{name} ALT {be}")
        assert_p2p_identical(plain, out, s, t, f"{name} ALT {be}")
    # a raw AltData prunes the same
    raw = _port(sssp(hg, s, device="cpu", goal="p2p", goal_param=t,
                     landmarks=tset.alt_data))
    assert_same(ref, raw, f"{name} AltData")


@pytest.mark.parametrize("name", list(GRAPHS))
def test_bidirectional_matches_reference(name):
    rg, dg, hg, s, t, rset, tset = _case(name)
    cfg = EngineConfig(use_alt=True, p2p_mode="bidirectional",
                       n_landmarks=N_LANDMARKS)
    ref = _np(ref_sssp(dg, s, goal="p2p", goal_param=t, config=cfg))
    uni = _np(ref_sssp(dg, s, goal="p2p", goal_param=t, landmarks=rset))
    for be in ("segment_min", "blocked"):
        opts = BLOCKED if be == "blocked" else {}
        out = _port(sssp(hg, s, device="cpu", goal="p2p", goal_param=t,
                         landmarks=tset, p2p_mode="bidirectional",
                         backend=be, **opts))
        assert_same(ref, out, f"{name} bidirectional {be}")
        assert_p2p_identical(uni, out, s, t, f"{name} bidirectional {be}")


def test_bidirectional_fused_matches_reference():
    """The fused bidirectional solve interleaves the two sides by calls,
    not rounds, so its counters are its own: held to the reference's
    fused bidirectional solve on two graphs."""
    for name in ("gr_16", "Road"):
        rg, dg, hg, s, t, rset, tset = _case(name)
        cfg = EngineConfig(use_alt=True, p2p_mode="bidirectional",
                           n_landmarks=N_LANDMARKS, backend="blocked_pallas",
                           fused_rounds=4, use_kernel=False, **BLOCKED)
        ref = _np(ref_sssp(dg, s, goal="p2p", goal_param=t, config=cfg))
        out = _port(sssp(hg, s, device="cpu", goal="p2p", goal_param=t,
                         landmarks=tset, p2p_mode="bidirectional",
                         backend="blocked", fused_rounds=4, **BLOCKED))
        assert_same(ref, out, f"{name} fused bidirectional")


def test_alt_p2p_with_the_reference_pallas_kernels():
    """The reference's Pallas kernels themselves (interpret mode), unfused
    and fused, on one small graph: the same answers as the port's."""
    rg, dg, hg, s, t, rset, tset = _case("gr_4")
    for fr in (0, 4):
        ref = _np(ref_sssp(dg, s, goal="p2p", goal_param=t, landmarks=rset,
                           backend="blocked_pallas", fused_rounds=fr,
                           interpret=True, **BLOCKED))
        out = _port(sssp(hg, s, device="cpu", goal="p2p", goal_param=t,
                         landmarks=tset, backend="blocked", fused_rounds=fr,
                         **BLOCKED))
        assert_same(ref, out, f"interpret-mode kernels, fused_rounds={fr}")


def test_landmarks_ignored_by_other_goals_and_bidirectional_needs_them():
    rg, dg, hg, s, t, rset, tset = _case("gr_8")
    for goal, gp in (("tree", None), ("knear", 5), ("bounded", 0.5)):
        a = _port(sssp(hg, s, device="cpu", goal=goal, goal_param=gp))
        b = _port(sssp(hg, s, device="cpu", goal=goal, goal_param=gp,
                       landmarks=tset, p2p_mode="bidirectional"))
        assert_same(a, b, goal)
    with pytest.raises(ValueError, match="needs a landmark set"):
        sssp(hg, s, device="cpu", goal="p2p", goal_param=t,
             p2p_mode="bidirectional")
    with pytest.raises(ValueError, match="unknown p2p_mode"):
        sssp(hg, s, device="cpu", goal="p2p", goal_param=t, landmarks=tset,
             p2p_mode="sideways")


# ---------------------------------------------------------------------------
# the kernels' plain versions, ALT branches
# ---------------------------------------------------------------------------

def _alt_lb(rng, n_out):
    lb = (rng.integers(0, 8, n_out) / 4).astype(np.float32)
    lb[rng.random(n_out) < 0.15] = np.inf
    return lb


@pytest.mark.parametrize("bound", [2.0, np.inf, 0.0, 3.25],
                         ids=["mid", "inf", "below-all", "ties"])
def test_edge_relax_alt_branch_matches_reference(bound):
    # integer weights and dists: many candidates land exactly on the
    # bound, which `<=` keeps
    dist, front, parent, (se, de, we, td, tf, bne, _) = _slab(
        seed=2, n_src=128, n_dst_blocks=2, m=600, ties=True)
    nb, n_out = 2, 2 * BV
    alt_lb = _alt_lb(np.random.default_rng(4), n_out)
    lb, ub = np.float32(0.5), np.float32(4.0)
    if bound == 3.25:
        alt_lb = np.where(np.isfinite(alt_lb), 0.25, np.inf).astype(
            np.float32)
    jargs = (jnp.asarray(dist), jnp.asarray(front),
             *map(jnp.asarray, (se, de, we)))
    kernel = rker.edge_relax(*jargs, *map(jnp.asarray, (td, tf, bne)), lb,
                             ub, jnp.asarray(alt_lb), np.float32(bound),
                             block_v=BV, tile_e=TE, n_dst_blocks=nb,
                             interpret=True)
    twin = rref.edge_relax_ref(*jargs, lb, ub, jnp.asarray(alt_lb),
                               np.float32(bound), block_v=BV,
                               n_dst_blocks=nb)
    t = torch.from_numpy
    f32 = lambda x: t(np.array(x, np.float32))
    slab = (t(dist), t(front.astype(bool)), t(parent), t(se), t(de), t(we),
            t(tf), f32(lb), f32(ub))
    vals, wins, counts = ops.relax_bucket(*slab, t(alt_lb), f32(bound),
                                          tile_e=TE, n_out=n_out)
    for want in (kernel, twin):
        np.testing.assert_array_equal(np.asarray(want[0]).view(np.int32),
                                      vals.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(want[1]), wins.numpy())
    assert int(kernel[2]) == int(counts[2])
    if bound == 0.0:
        assert not torch.isfinite(vals).any()
    if bound == np.inf:
        plain = ops.relax_bucket(*slab, tile_e=TE, n_out=n_out)
        finite_lb = np.isfinite(alt_lb)
        assert torch.equal(vals[finite_lb], plain[0][finite_lb])


@functools.lru_cache(maxsize=None)
def _road12():
    rg = GRAPHS["Road"]
    rbg = ref_build_blocked(rg.to_device(), block_v=64, tile_e=64)
    return rbg, rrelax.fused_slab(rbg), convert.from_reference(
        ref_arrays(rbg), "cpu")


@pytest.mark.parametrize("case", ["mid", "inf", "below-all", "tightens"])
def test_fused_alt_branch_matches_reference(case):
    rbg, rfs, bg = _road12()
    n, n_out = rbg.n, bg.n_out
    rng = np.random.default_rng(6)
    dist = np.full(n_out, np.inf, np.float32)
    seeds = rng.choice(n, 40, replace=False)
    dist[seeds] = rng.uniform(0.0, 3.0, seeds.size).astype(np.float32)
    parent = np.full(n_out, -1, np.int32)
    parent[seeds] = rng.integers(0, n, seeds.size)
    frontier = np.zeros(n_out, bool)
    frontier[seeds[:20]] = True
    alt_lb = np.where(np.arange(n_out) < n, _alt_lb(rng, n_out),
                      np.inf).astype(np.float32)
    tgt = int(seeds[30]) if case != "tightens" else int(
        np.setdiff1d(np.arange(n), seeds)[5])
    prune_ub = {"mid": 4.0, "inf": np.inf, "below-all": 0.0,
                "tightens": np.inf}[case]
    infl = np.float32(1.0 + 4.0 * rlm._EPS * 100)
    lb, ub = np.float32(0.5), np.float32(20.0)
    jin = (jnp.asarray(dist), jnp.asarray(parent), jnp.asarray(frontier),
           rbg.deg, rfs.src, rfs.dst, rfs.w, rfs.tile_dst, rfs.tile_first,
           lb, ub, jnp.asarray(alt_lb), np.float32(prune_ub), infl,
           np.int32(tgt))
    kernel = rker.edge_relax_fused(*jin, block_v=rbg.block_v,
                                   tile_e=rbg.tile_e, fused_rounds=6,
                                   interpret=True)
    twin = rref.edge_relax_fused_ref(*jin, block_v=rbg.block_v,
                                     tile_e=rbg.tile_e, fused_rounds=6)
    t = torch.from_numpy
    f32 = lambda x: t(np.array(x, np.float32))
    out = ops.relax_fused(t(dist), t(parent), t(frontier), bg.deg, bg.src,
                          bg.dst, bg.w, bg.tile_first, f32(lb), f32(ub),
                          t(alt_lb), f32(prune_ub), f32(infl),
                          t(np.array(tgt, np.int32)), tile_e=bg.tile_e,
                          fused_rounds=6)
    for want in (kernel, twin):
        np.testing.assert_array_equal(np.asarray(want[0]).view(np.int32),
                                      out[0].numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(want[1]), out[1].numpy())
        np.testing.assert_array_equal(np.asarray(want[2]),
                                      out[2].numpy().astype(np.int32))
        np.testing.assert_array_equal(np.asarray(want[3]), out[3].numpy())
    cnt = dict(zip(ops.FUSED_COUNTERS, out[3].tolist()))
    if case == "below-all":
        assert cnt["n_relax"] == 0 and cnt["n_pruned"] > 0
    if case == "tightens":
        # the target is reached within the call and the cut bites after it
        assert np.isinf(dist[tgt]) and np.isfinite(float(out[0][tgt]))
        assert cnt["n_pruned"] > 0 and cnt["n_exec"] > 1
