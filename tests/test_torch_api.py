"""Port parity: the solver facade (``repro_torch.api``), single tier (and
the sharded tier's entry points at one gloo rank).

Mirrors ``tests/test_api.py``: one ``EngineConfig`` + ``SolveSpec`` pair
drives all four goal kinds, scalar and batched, on ``segment_min`` and
``blocked``, and every result is bitwise the reference facade's (dist,
parent, logical counters); ``solve_many`` groups mixed kinds into one
batch per kind; ``SolveResult`` shapes lazily; foreign layouts and a
closed solver fail loudly; the deprecated
``sssp_*`` shims warn and match the facade.
"""
import functools

import numpy as np
import pytest
import torch

import repro.data.generators as rgen
from repro.api import EngineConfig as RefConfig
from repro.api import SolveSpec as RefSpec
from repro.api import Solver as RefSolver
from repro_torch import convert
from repro_torch.api import EngineConfig, SolveResult, SolveSpec, Solver
from repro_torch.core.config import ConfigError, FacadeDeprecationWarning
from repro_torch.core.graph import build_blocked, slice_for_shard
from repro_torch.core.sssp import (LOGICAL_METRIC_FIELDS, sssp_bounded,
                                   sssp_knear, sssp_p2p)
from test_torch_graph import ref_arrays
from torch_serve_common import gloo_one
from release_xla import release_compiled  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.config.FacadeDeprecationWarning")

SIDE = 12
BLOCKED = dict(block_v=64, tile_e=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _road():
    rg = rgen.road_grid(SIDE, seed=2)
    return rg, convert.from_reference(ref_arrays(rg), "cpu")


def all_kind_specs(mod, n, single=True):
    """One spec per goal kind (scalar or batch shape), in ``mod``'s
    ``SolveSpec``."""
    S = mod
    if single:
        return [S.tree(0), S.p2p(0, n - 1), S.bounded(0, 2.5),
                S.knear(0, 5)]
    return [S.tree([0, 5]), S.p2p([0, 5], [n - 1, 30]),
            S.bounded([0, 5], [2.5, 1.5]), S.knear([0, 5], [5, 3])]


@functools.lru_cache(maxsize=None)
def _ref_results():
    rg, _ = _road()
    solver = RefSolver.open(rg)
    specs = (all_kind_specs(RefSpec, rg.n)
             + all_kind_specs(RefSpec, rg.n, single=False))
    return [solver.solve(s) for s in specs]


def assert_bitwise(res, ref, msg=""):
    d_ref, p_ref, m_ref = ref
    np.testing.assert_array_equal(np.asarray(res.dist).view(np.int32),
                                  np.asarray(d_ref).view(np.int32),
                                  err_msg=msg)
    np.testing.assert_array_equal(np.asarray(res.parent),
                                  np.asarray(p_ref), err_msg=msg)
    for f in LOGICAL_METRIC_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(res.metrics, f)),
                                      np.asarray(getattr(m_ref, f)),
                                      err_msg=f"{msg}:{f}")


CONFIGS = {"segment_min": dict(), "blocked": dict(backend="blocked",
                                                  **BLOCKED),
           "adaptive": dict(backend="blocked", policy="adaptive",
                            **BLOCKED)}


@pytest.mark.parametrize("name", ["segment_min", "blocked"])
def test_single_tier_parity_all_kinds(name):
    """Every kind, scalar and batched, bitwise the reference facade's
    (segment_min; the reference's backends agree bitwise)."""
    rg, hg = _road()
    solver = Solver.open(hg, EngineConfig(**CONFIGS[name]), device="cpu")
    specs = all_kind_specs(SolveSpec, rg.n) + all_kind_specs(
        SolveSpec, rg.n, single=False)
    for spec, ref in zip(specs, _ref_results()):
        res = solver.solve(spec)
        assert isinstance(res, SolveResult) and res.tier == "single"
        assert_bitwise(res, ref, msg=f"{name} {spec.kind}/"
                                     f"batched={spec.batched}")
    if name == "blocked":
        assert bool((res.metrics.n_tiles_scanned > 0).all())


def test_adaptive_and_fused_sessions_match_the_reference():
    rg, hg = _road()
    for kw in (dict(policy="adaptive"),
               dict(backend="blocked", fused_rounds=2, **BLOCKED)):
        ref_solver = RefSolver.open(rg, RefConfig(
            policy=kw.get("policy", "static")))
        solver = Solver.open(hg, EngineConfig(**kw), device="cpu")
        for a, b in zip(all_kind_specs(RefSpec, rg.n, single=False),
                        all_kind_specs(SolveSpec, rg.n, single=False)):
            assert_bitwise(solver.solve(b), ref_solver.solve(a),
                           msg=f"{kw} {b.kind}")


def test_use_alt_session_builds_landmarks_once():
    rg, hg = _road()
    ref_solver = RefSolver.open(rg, RefConfig(use_alt=True, n_landmarks=4))
    solver = Solver.open(hg, EngineConfig(backend="blocked", use_alt=True,
                                          n_landmarks=4, **BLOCKED),
                         device="cpu")
    assert solver.landmarks is not None
    np.testing.assert_array_equal(np.asarray(ref_solver.landmarks.D),
                                  solver.landmarks.D.numpy())
    for spec, ref_spec in ((SolveSpec.p2p([0, 5, 17], [rg.n - 1, 30, 2]),
                            RefSpec.p2p([0, 5, 17], [rg.n - 1, 30, 2])),
                           (SolveSpec.p2p(3, 100), RefSpec.p2p(3, 100))):
        res = solver.solve(spec)
        assert_bitwise(res, ref_solver.solve(ref_spec), msg="alt")
        assert int(res.metrics.n_pruned.sum()) > 0


def test_solve_many_groups_mixed_kinds():
    """Mixed kinds: one batch per kind, each result bitwise its own
    ``solve`` (and the reference's ``solve_many``)."""
    rg, hg = _road()
    solver = Solver.open(hg, EngineConfig(backend="blocked", **BLOCKED),
                         device="cpu")
    mixed = [SolveSpec.tree(3), SolveSpec.p2p([0, 5], [100, 30]),
             SolveSpec.knear(9, 4), SolveSpec.tree([1, 2]),
             SolveSpec.p2p(7, 8), SolveSpec.bounded([4, 6], 1.5)]
    ref_mixed = [RefSpec.tree(3), RefSpec.p2p([0, 5], [100, 30]),
                 RefSpec.knear(9, 4), RefSpec.tree([1, 2]),
                 RefSpec.p2p(7, 8), RefSpec.bounded([4, 6], 1.5)]
    many = solver.solve_many(mixed)
    refs = RefSolver.open(rg).solve_many(ref_mixed)
    assert [r.spec for r in many] == mixed
    for res, spec, ref in zip(many, mixed, refs):
        one = solver.solve(spec)
        assert_bitwise(res, (one.dist, one.parent, one.metrics),
                       msg=spec.kind)
        assert_bitwise(res, ref, msg=f"reference {spec.kind}")
        assert res.batched == spec.batched
    assert solver.solve_many([]) == []
    assert len(solver.solve_many([SolveSpec.tree(0)])) == 1


def test_solvespec_validation():
    with pytest.raises(ValueError):
        SolveSpec(sources=0, kind="nope")
    with pytest.raises(ValueError):
        SolveSpec.p2p(0, None)
    with pytest.raises(ValueError):
        SolveSpec(sources=0, kind="tree", target=3)
    with pytest.raises(ValueError):
        SolveSpec.p2p(0, -1)
    with pytest.raises(ValueError):
        SolveSpec.knear(0, 0)
    with pytest.raises(ValueError):
        SolveSpec.bounded(0, -1.0)
    with pytest.raises(ValueError):
        SolveSpec.p2p([0, 1], [2])
    with pytest.raises(ValueError):
        SolveSpec.p2p(0, [1, 2])
    with pytest.raises(ValueError):
        SolveSpec.tree([])
    spec = SolveSpec.p2p([0, 1], 7)
    assert spec.sources == (0, 1) and spec.batched
    assert spec.slot_params() == [7, 7]
    assert not SolveSpec.tree(3).batched
    assert spec == SolveSpec.p2p(np.array([0, 1]), np.int64(7))


def test_solve_result_shaping():
    rg, hg = _road()
    solver = Solver.open(hg, device="cpu")
    res = solver.solve(SolveSpec.p2p(0, 100))
    dist, parent, metrics = res
    assert tuple(dist.shape) == (rg.n,)
    assert res.distance() == float(dist[100])
    path = res.paths()
    assert path[0] == 0 and path[-1] == 100
    par = parent.numpy()
    assert all(par[path[i + 1]] == path[i] for i in range(len(path) - 1))
    assert res.normalized()["n_rounds"] == int(metrics.n_rounds)
    assert res.block_until_ready() is res
    rb = solver.solve(SolveSpec.p2p([0, 5], [100, 30]))
    assert rb.distance(slot=1) == float(rb.dist[1, 30])
    paths = rb.paths()
    assert paths[0][-1] == 100 and paths[1][-1] == 30
    assert rb.paths(np.array([100, 30])) == paths
    with pytest.raises(ValueError):
        rb.paths([100, 30, 7])
    assert rb.normalized(slot=0)["reachable"] > 0
    kn = solver.solve(SolveSpec.knear(0, 3))
    assert len(kn.nearest()) == 3
    # the same shaping from numpy fields
    as_np = SolveResult(spec=rb.spec, dist=rb.dist.numpy(),
                        parent=rb.parent.numpy(), metrics=rb.metrics,
                        deg=rb.deg, tier="single")
    assert as_np.paths() == paths and as_np.distance(slot=0) == \
        rb.distance(slot=0)
    # batched results need a slot
    with pytest.raises(ValueError, match="slot"):
        rb.distance()
    with pytest.raises(ValueError, match="slot"):
        rb.normalized()
    rk = solver.solve(SolveSpec.knear([0, 5], [3, 4]))
    with pytest.raises(ValueError, match="slot"):
        rk.nearest()
    assert len(rk.nearest(slot=1)) == 4
    ref = RefSolver.open(rg).solve(RefSpec.knear([0, 5], [3, 4]))
    assert rk.nearest(slot=1) == ref.nearest(slot=1)
    assert rk.normalized(slot=0) == ref.normalized(slot=0)


def test_check_layout_rejections():
    """tests/test_config.py::test_blocked_backend_rejects_unpadded_or_
    foreign_layouts and ::test_segment_min_rejects_foreign_device_graph_
    layouts on the port."""
    _, hg = _road()
    cfg = EngineConfig(backend="blocked_pallas")
    with pytest.raises(ConfigError, match="needs a BlockedGraph"):
        Solver.open(hg, cfg, layout=hg.to_device("cpu"), device="cpu")
    other = build_blocked(convert.from_reference(
        ref_arrays(rgen.road_grid(10, seed=1)), "cpu"), device="cpu",
        **BLOCKED)
    with pytest.raises(ConfigError, match="does not cover"):
        Solver.open(hg, cfg, layout=other, device="cpu")
    slab = slice_for_shard(hg, 1, 2, block_v=32, tile_e=32)
    with pytest.raises(ConfigError):
        Solver.open(hg, cfg, layout=slab, device="cpu")
    bl = build_blocked(hg, device="cpu", **BLOCKED)
    with pytest.raises(ConfigError, match="tile_e"):
        Solver.open(hg, EngineConfig(backend="blocked_pallas", tile_e=128),
                    layout=bl, device="cpu")
    with pytest.raises(ConfigError, match="cannot consume"):
        Solver.open(hg, EngineConfig(), layout=bl, device="cpu")
    s = Solver.open(hg, EngineConfig(backend="blocked_pallas"), layout=bl,
                    device="cpu")
    assert np.isfinite(s.solve(SolveSpec.p2p(0, 100)).distance())
    foreign = convert.from_reference(ref_arrays(
        rgen.road_grid(SIDE, seed=9)), "cpu").to_device("cpu")
    with pytest.raises(ConfigError, match="does not match"):
        Solver.open(hg, EngineConfig(), layout=foreign, device="cpu")
    with pytest.raises(ConfigError, match="DeviceGraph"):
        Solver.open(hg, EngineConfig(), layout="not a layout", device="cpu")
    s = Solver.open(hg, EngineConfig(), layout=hg.to_device("cpu"),
                    device="cpu")
    assert np.isfinite(s.solve(SolveSpec.p2p(0, 100)).distance())
    with pytest.raises(TypeError, match="HostGraph or DeviceGraph"):
        Solver.open("graph")


def test_out_of_range_specs_and_closed_solver():
    _, hg = _road()
    s = Solver.open(hg, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        s.solve(SolveSpec.tree(hg.n + 5))
    with pytest.raises(ValueError, match="out of range"):
        s.solve(SolveSpec.tree([0, hg.n]))
    with pytest.raises(ValueError, match="out of range"):
        s.solve(SolveSpec.p2p(0, hg.n + 1))
    with pytest.raises(ValueError, match="out of range"):
        s.solve_many([SolveSpec.tree(0), SolveSpec.p2p([0, 1], [1, hg.n])])
    with pytest.raises(TypeError, match="SolveSpec"):
        s.solve((0, 1))
    assert "tier='single'" in repr(s) and s.device_graph.n == hg.n
    assert s.landmarks is None
    assert s.warmup(kinds=("tree", "p2p"), batch_sizes=(1, 2)) == [
        {"kind": k, "batch": b, "tier": "single"}
        for k in ("tree", "p2p") for b in (1, 2)]
    with s:
        pass
    with pytest.raises(RuntimeError, match="closed"):
        s.solve(SolveSpec.tree(0))
    with pytest.raises(RuntimeError, match="closed"):
        s.solve_many([SolveSpec.tree(0)])
    s.close()


# the ids name the ROADMAP item that ported each entry point (the tuner,
# item 8; the serving plane, item 9; the sharded tier, item 10)
@pytest.mark.parametrize("what", [
    "sharded", "routed", "tuned", "submit", "router", "registry"], ids=[
    "sharded-item 10", "routed-item 9", "tuned-item 8", "submit-item 9",
    "router-item 9", "registry-item 9"])
def test_later_slices_raise_naming_their_roadmap_item(what, gloo_one):
    """What earlier slices left raising runs now (ROADMAP queue 1 item
    10, the sharded tier, at one gloo rank): opened directly (every kind,
    scalar and batched, bitwise the reference facade), a tune on a
    sharded base (the reference's trajectory), and a sharded-tier graph
    behind the entry points items 8 and 9 ported (the routed tier's
    ``solve``, ``submit``, the router and the registry), whose answers
    are the reference's.  ``test_torch_sharded_tier.py`` holds the tier
    in full."""
    from repro.tune import tune as ref_tune
    from repro_torch.serve.queries import Query
    from repro_torch.serve.registry import ShardedGraphEngine
    from repro_torch.tune import tune
    rg, hg = _road()
    refs = _ref_results()       # all kinds, scalar then batched
    if what == "sharded":
        s = Solver.open(hg, EngineConfig(tier=what), device="cpu")
        specs = all_kind_specs(SolveSpec, rg.n) + all_kind_specs(
            SolveSpec, rg.n, single=False)
        for spec, ref in zip(specs, refs):
            res = s.solve(spec)
            assert res.tier == "sharded"
            assert_bitwise(res, ref, msg=f"sharded {spec}")
        return
    if what == "tuned":
        kw = dict(budget=2, n_sources=2, store=None)
        want = ref_tune(rg, RefConfig(tier="sharded"), **kw)
        got = tune(hg, EngineConfig(tier="sharded"), device="cpu", **kw)
        assert got.trajectory == want.trajectory
        return
    s = Solver.open(hg, EngineConfig(tier="routed", shard_threshold_n=1,
                                     devices=("cpu",)))
    assert s.tier == "routed" and s.registry.tier(s.gid) == "sharded"
    tree0, tree05 = refs[0], refs[4]        # tree(0), tree([0, 5])
    try:
        if what == "routed":
            got = s.solve(SolveSpec.tree(0))
            want = (tree0.dist, tree0.parent)
        elif what == "submit":
            got = s.submit(SolveSpec.tree([0, 5])).result(timeout=60)
            want = (tree05.dist, tree05.parent)
        elif what == "router":
            fut = s.router.submit(Query(gid=s.gid, source=0))
            s.router.drain()
            got = fut.result(timeout=0)
            assert got.served_by == "mesh"
            want = (tree0.dist, tree0.parent)
        else:
            eng = s.registry.engine(s.gid)
            assert isinstance(eng, ShardedGraphEngine)
            d, p, m = eng.run_batch([0, 5])
            assert_bitwise(SolveResult(spec=SolveSpec.tree([0, 5]), dist=d,
                                       parent=p, metrics=m, deg=s.deg,
                                       tier="sharded"), tree05, "engine")
            return
        np.testing.assert_array_equal(np.asarray(got.dist).view(np.int32),
                                      np.asarray(want[0]).view(np.int32))
        np.testing.assert_array_equal(np.asarray(got.parent),
                                      np.asarray(want[1]))
    finally:
        s.close()


def test_entry_needs_a_card_unless_told_cpu():
    _, hg = _road()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Solver.open(hg)
        with pytest.raises(ConfigError, match="out of range"):
            Solver.open(hg, EngineConfig(devices=(0,)))
    s = Solver.open(hg, EngineConfig(devices=("cpu",)))
    assert s.device_graph.device.type == "cpu"


def test_deprecated_wrappers_warn_and_match_facade():
    _, hg = _road()
    dg = hg.to_device("cpu")
    solver = Solver.open(hg, device="cpu")
    for shim, spec in [
            (lambda: sssp_p2p(dg, 0, 100, device="cpu"),
             SolveSpec.p2p(0, 100)),
            (lambda: sssp_bounded(dg, 0, 2.5, device="cpu"),
             SolveSpec.bounded(0, 2.5)),
            (lambda: sssp_knear(dg, 0, 5, device="cpu"),
             SolveSpec.knear(0, 5))]:
        with pytest.warns(FacadeDeprecationWarning, match="deprecated"):
            old = shim()
        assert_bitwise(solver.solve(spec), old, msg=spec.kind)
    with pytest.raises(FacadeDeprecationWarning):    # escalated here
        sssp_p2p(dg, 0, 100, device="cpu")
