"""Port parity: batched solves (``repro_torch.core.sssp.sssp_batch``).

Every slot of the port's batch must be bitwise the reference's
``sssp_batch`` slot (a vmapped loop that freezes finished slots) and the
port's own single solve from that source with that goal parameter:
dist, parent and every logical counter.  Then the batch's own contract:
near targets stop in fewer rounds, the reference's shape and bound
errors, and the batched relaxation round (kernel plain version, backend)
against single rounds, bitwise.
"""
import functools

import numpy as np
import pytest
import torch

import repro.data.generators as rgen
from repro.core.config import EngineConfig as RefConfig
from repro.core.landmarks import build_landmarks as ref_build_landmarks
from repro.core.sssp import sssp_batch as ref_sssp_batch
from repro_torch import convert
from repro_torch.core import relax
from repro_torch.core.graph import build_blocked
from repro_torch.core.landmarks import LandmarkSet
from repro_torch.core.sssp import (LOGICAL_METRIC_FIELDS, metrics_dict, sssp,
                                   sssp_batch)
from repro_torch.kernels.edge_relax import ops, ref
from test_torch_graph import ref_arrays
from release_xla import release_compiled  # noqa: F401

BLOCKED = dict(block_v=64, tile_e=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _case(name):
    rg = {"road": lambda: rgen.road_grid(12, seed=2),
          "kron": lambda: rgen.kronecker(8, 8, seed=1)}[name]()
    return rg, rg.to_device(), convert.from_reference(ref_arrays(rg), "cpu")


def _goal_params(rg, goal):
    """Four sources and per-slot parameters of each goal kind."""
    srcs = [0, 5, int(np.argmax(rg.deg)), 17]
    return srcs, {"tree": None, "p2p": [rg.n - 1, 30, 7, 17],
                  "bounded": [2.5, 1.5, 0.75, 4.0],
                  "knear": [5, 3, 40, 1]}[goal]


def assert_slots(ref, out, what, slots=None):
    """Bitwise dist/parent and equal logical counters per slot."""
    d, p, m = out
    n_slots = d.shape[0]
    for i in range(n_slots) if slots is None else slots:
        np.testing.assert_array_equal(np.asarray(ref[0][i]).view(np.int32),
                                      d[i].numpy().view(np.int32),
                                      err_msg=f"{what} slot {i}: dist")
        np.testing.assert_array_equal(np.asarray(ref[1][i]), p[i].numpy(),
                                      err_msg=f"{what} slot {i}: parent")
        for f in LOGICAL_METRIC_FIELDS:
            assert int(np.asarray(getattr(ref[2], f))[i]) == int(
                getattr(m, f)[i]), (what, i, f)


@functools.lru_cache(maxsize=None)
def _ref_batch(name, goal):
    rg, dg, _ = _case(name)
    srcs, gps = _goal_params(rg, goal)
    return ref_sssp_batch(dg, srcs, goal=goal, goal_params=gps)


@pytest.mark.parametrize("opts", [dict(backend="segment_min"),
                                  dict(backend="blocked", **BLOCKED),
                                  dict(backend="blocked", fused_rounds=2,
                                       **BLOCKED)],
                         ids=["segment_min", "blocked", "fused"])
@pytest.mark.parametrize("goal", ["tree", "p2p", "bounded", "knear"])
@pytest.mark.parametrize("name", ["road", "kron"])
def test_batch_matches_the_reference_and_single_solves(name, goal, opts):
    """Per slot: bitwise the reference's ``sssp_batch`` (its backends
    agree bitwise, as its own tests hold) and the port's ``sssp``."""
    rg, dg, hg = _case(name)
    srcs, gps = _goal_params(rg, goal)
    out = sssp_batch(hg, srcs, goal=goal, goal_params=gps, device="cpu",
                     **opts)
    assert_slots(_ref_batch(name, goal), out, f"{name} {goal} {opts}")
    if goal in ("p2p", "knear"):
        for i, s in enumerate(srcs):
            one = sssp(hg, s, goal=goal, goal_param=gps[i], device="cpu",
                       **opts)
            assert torch.equal(one[0].view(torch.int32),
                               out[0][i].view(torch.int32)), i
            assert torch.equal(one[1], out[1][i]), i
            md = metrics_dict(one[2])
            assert all(md[f] == int(getattr(out[2], f)[i])
                       for f in LOGICAL_METRIC_FIELDS), i
            assert md["n_host_syncs"] == float(out[2].n_host_syncs[i])


def test_batch_with_the_reference_pallas_kernel():
    """The reference's batched solve through its Pallas kernel
    (interpret mode, vmapped) against the port's batched kernel path."""
    rg = rgen.kronecker(7, 4, seed=3)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    srcs = [int(np.argmax(rg.deg)), 2, 9]
    ref = ref_sssp_batch(rg.to_device(), srcs, backend="blocked_pallas",
                         interpret=True, **BLOCKED)
    out = sssp_batch(hg, srcs, backend="blocked", device="cpu", **BLOCKED)
    assert_slots(ref, out, "interpret-mode kernel")


@functools.lru_cache(maxsize=None)
def _landmarks(name):
    rg, dg, _ = _case(name)
    rset = ref_build_landmarks(dg, 4, "farthest")
    tset = LandmarkSet(landmarks=np.asarray(rset.landmarks),
                       D=torch.from_numpy(np.array(rset.D)),
                       strategy=rset.strategy, sym=bool(rset.sym),
                       max_hops=int(rset.max_hops))
    return rset, tset


@pytest.mark.parametrize("opts", [dict(backend="segment_min"),
                                  dict(backend="blocked", **BLOCKED),
                                  dict(backend="blocked", fused_rounds=2,
                                       **BLOCKED),
                                  dict(backend="blocked",
                                       p2p_mode="bidirectional", **BLOCKED)],
                         ids=["segment_min", "blocked", "fused",
                              "bidirectional"])
@pytest.mark.parametrize("name", ["road", "kron"])
def test_alt_batch_matches_the_reference(name, opts):
    """ALT p2p batches, unidirectional on each backend and
    bidirectional: per slot bitwise the reference's batch with the same
    landmark set, some candidate pruned."""
    rg, dg, hg = _case(name)
    rset, tset = _landmarks(name)
    srcs, gps = _goal_params(rg, "p2p")
    mode = opts.get("p2p_mode", "unidirectional")
    ref = ref_sssp_batch(dg, srcs, goal="p2p", goal_params=gps,
                         landmarks=rset,
                         config=RefConfig(use_alt=True, p2p_mode=mode))
    out = sssp_batch(hg, srcs, goal="p2p", goal_params=gps, device="cpu",
                     landmarks=tset, **opts)
    assert_slots(ref, out, f"{name} alt {opts}")
    assert int(out[2].n_pruned.sum()) > 0


def test_use_alt_builds_landmarks_for_the_batch():
    rg, dg, hg = _case("road")
    srcs, gps = _goal_params(rg, "p2p")
    ref = ref_sssp_batch(dg, srcs, goal="p2p", goal_params=gps,
                         config=RefConfig(use_alt=True, n_landmarks=4))
    out = sssp_batch(hg, srcs, goal="p2p", goal_params=gps, device="cpu",
                     use_alt=True, n_landmarks=4)
    assert_slots(ref, out, "use_alt")


@pytest.mark.parametrize("opts", [dict(backend="segment_min"),
                                  dict(backend="blocked", **BLOCKED)],
                         ids=["segment_min", "blocked"])
def test_one_slot_equals_sssp(opts):
    rg, dg, hg = _case("kron")
    for goal, gp in (("tree", None), ("p2p", 40), ("knear", 12)):
        one = sssp(hg, 3, goal=goal, goal_param=gp, device="cpu", **opts)
        out = sssp_batch(hg, [3], goal=goal,
                         goal_params=None if gp is None else [gp],
                         device="cpu", **opts)
        assert torch.equal(one[0], out[0][0]) and torch.equal(one[1],
                                                              out[1][0])
        a = metrics_dict(one[2])
        assert all(a[f] == int(getattr(out[2], f)[0])
                   for f in metrics_dict(one[2]))


def test_near_targets_stop_in_fewer_rounds():
    """tests/test_query_goals.py::test_batched_goal_params_per_slot on the
    port: per-slot targets in one batch, each d(s,t) the tree's, the
    nearest target done first."""
    rg = rgen.road_grid(16, seed=5)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    d_full = sssp(hg, 0, device="cpu")[0]
    tgts = [3, 40, 100, 255]
    dist, _, metrics = sssp_batch(hg, [0] * 4, goal="p2p", goal_params=tgts,
                                  device="cpu")
    for i, t in enumerate(tgts):
        assert dist[i, t].item() == d_full[t].item()
    rounds = metrics.n_rounds.tolist()
    assert rounds[0] <= rounds[-1] and rounds[0] < rounds[-1]
    assert metrics.n_host_syncs[0] < metrics.n_host_syncs[-1]


def test_batch_shape_and_bound_errors():
    """The reference's errors (tests/test_query_goals.py::
    test_goal_validation), raised before any solve."""
    rg, dg, hg = _case("road")
    for kw, exc, match in (
            (dict(goal="p2p", goal_params=[1]), ValueError, "shape"),
            (dict(goal="p2p", goal_params=[1, -2]), ValueError,
             "out of range"),
            (dict(goal="p2p", goal_params=[1, hg.n]), ValueError,
             "out of range"),
            (dict(goal="p2p"), ValueError, "requires a parameter"),
            (dict(goal="nope", goal_params=[1, 2]), ValueError,
             "unknown goal"),
            (dict(goal="knear", goal_params=[[1], [2]]), ValueError,
             "shape")):
        for mod_batch, g in ((ref_sssp_batch, dg), (sssp_batch, hg)):
            extra = {} if mod_batch is ref_sssp_batch else dict(device="cpu")
            with pytest.raises(exc, match=match):
                mod_batch(g, [0, 1], **kw, **extra)
    with pytest.raises(ValueError, match="out of range"):
        sssp_batch(hg, [0, hg.n], device="cpu")
    with pytest.raises(ValueError, match="non-empty 1-D"):
        sssp_batch(hg, [], device="cpu")
    with pytest.raises(TypeError, match="unknown engine options"):
        sssp_batch(hg, [0, 1], device="cpu", goal_param=3)


def _round_inputs(rng, bg, n_slots, alt):
    n_out = bg.n_out
    dist = rng.integers(0, 6, (n_slots, n_out)).astype(np.float32)
    dist[rng.random((n_slots, n_out)) < 0.2] = np.inf
    paths = (rng.random((n_slots, n_out)) < 0.3) & np.isfinite(dist)
    parent = np.where(np.isfinite(dist),
                      rng.integers(0, n_out, (n_slots, n_out)), -1)
    t = torch.from_numpy
    lb = t(rng.integers(0, 3, n_slots).astype(np.float32))
    ub = t(rng.integers(3, 8, n_slots).astype(np.float32))
    extra = ()
    if alt:
        extra = (t((rng.integers(0, 8, (n_slots, n_out)) / 4)
                   .astype(np.float32)),
                 t(rng.choice([2.0, np.inf, 0.0, 3.0], n_slots)
                   .astype(np.float32)))
    return (t(dist), t(paths), t(parent.astype(np.int32)), lb, ub, *extra)


@pytest.mark.parametrize("alt", [False, True], ids=["plain", "alt"])
def test_batched_plain_round_equals_single_rounds(alt):
    """``ref.edge_relax_batch_ref`` and the batched ``relax_bucket`` on the
    CPU against one single plain round per active slot, bitwise, with an
    active list that skips slots (whose rows hold no candidate)."""
    rng = np.random.default_rng(3)
    rg = rgen.kronecker(8, 8, seed=4)
    bg = build_blocked(convert.from_reference(ref_arrays(rg), "cpu"),
                       device="cpu", **BLOCKED)
    dist, paths, parent, lb, ub, *extra = _round_inputs(rng, bg, 5, alt)
    kw = dict(tile_e=bg.tile_e, n_out=bg.n_out)
    slab = (bg.src, bg.dst, bg.w, bg.tile_first)
    active = torch.tensor([0, 2, 3], dtype=torch.int32)
    launches = ops.LAUNCHES.edge_relax_batch
    for fn in (lambda: ref.edge_relax_batch_ref(
            dist, paths, parent, *slab, lb, ub, *extra, active=active, **kw),
            lambda: ops.relax_bucket(dist, paths, parent, *slab, lb, ub,
                                     *extra, active=active, index=bg.index,
                                     **kw)):
        vals, wins, cnt = fn()
        for i in range(5):
            one = ref.edge_relax_partials_ref(
                dist[i], paths[i], parent[i], *slab, lb[i], ub[i],
                *(() if not alt else (extra[0][i], extra[1][i])), **kw)
            if i in (0, 2, 3):
                assert torch.equal(vals[i].view(torch.int32),
                                   one[0].view(torch.int32)), i
                assert torch.equal(wins[i], one[1]) and torch.equal(
                    cnt[i], one[2]), i
            else:
                assert bool(torch.isinf(vals[i]).all()) and int(
                    cnt[i].abs().sum()) == 0
    assert ops.LAUNCHES.edge_relax_batch == launches     # CPU: no launch


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
def test_batched_backend_round_equals_single_rounds(backend):
    """``relax_window`` with a slot axis and ``active=``: each active
    slot's dist, parent, improved set and counters bitwise the one-state
    round's; inactive slots unchanged with zero counters."""
    rng = np.random.default_rng(8)
    rg = rgen.road_grid(12, seed=1)
    dg = convert.from_reference(ref_arrays(rg), "cpu").to_device("cpu")
    be = relax.get_backend(backend)
    layout = be.prepare(dg, **(BLOCKED if backend == "blocked" else {}))
    n_slots, n = 4, dg.n
    dist = torch.from_numpy(rng.integers(0, 6, (n_slots, n))
                            .astype(np.float32))
    dist[torch.from_numpy(rng.random((n_slots, n)) < 0.3)] = float("inf")
    frontier = torch.from_numpy(rng.random((n_slots, n)) < 0.4) \
        & dist.isfinite()
    parent = torch.where(dist.isfinite(), torch.from_numpy(
        rng.integers(0, n, (n_slots, n)).astype(np.int32)), -1)
    lb = torch.tensor([0.0, 1.0, 2.0, 1.0])
    ub = torch.tensor([4.0, 5.0, 3.0, 9.0])
    slots = relax.Slots(mask=torch.tensor([True, False, True, True]),
                        ids=torch.tensor([0, 2, 3], dtype=torch.int32))
    d2, p2, rm = be.relax_window(layout, dist, parent, frontier, lb, ub,
                                 active=slots)
    for i in range(n_slots):
        if not bool(slots.mask[i]):
            assert torch.equal(d2[i], dist[i]) and torch.equal(p2[i],
                                                               parent[i])
            assert int(rm.n_relax[i]) == 0 and not bool(rm.improved[i].any())
            continue
        d1, p1, rm1 = be.relax_window(layout, dist[i], parent[i],
                                      frontier[i], lb[i], ub[i])
        assert torch.equal(d2[i].view(torch.int32), d1.view(torch.int32))
        assert torch.equal(p2[i], p1)
        assert torch.equal(rm.improved[i], rm1.improved)
        for f in ("n_trav", "n_relax", "n_updates", "n_extended",
                  "n_pruned", "n_tiles_scanned"):
            assert getattr(rm, f)[i].item() == getattr(rm1, f).item(), f
