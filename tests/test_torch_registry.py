"""Port parity: the multi-graph registry (``repro_torch.serve.registry``).

Mirrors ``tests/test_serve_registry.py`` (LRU eviction and rebuild, per
backend keys, factory specs, per-key build futures, generations and
listeners, warmup, hints and feedback) on the CPU, with the engines'
batches held bitwise against the reference registry's (dist, parent,
logical counters), the eccentricity hints against the reference's, the
landmark disk cache shared with it, ``apply_delta`` against the
reference's (patched engines, repaired cached trees, the report), and
the sharded tier's engine (at one gloo rank) against the reference's
and the single tier's.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.delta import EdgeDelta as RefDelta
from repro.serve.registry import GraphRegistry as RefRegistry
from repro.serve.registry import estimate_eccentricity as ref_ecc
from repro_torch.core.config import EngineConfig
from repro_torch.core.graph import build_blocked
from repro_torch.core.sssp import sssp
from repro_torch.delta import EdgeDelta
from repro_torch.serve.registry import (GraphEngine, GraphRegistry,
                                        ShardedGraphEngine,
                                        estimate_eccentricity)
from torch_serve_common import CPU, gloo_one, graph, port, same_batch
from release_xla import release_compiled  # noqa: F401

BLOCKED = dict(block_v=64, tile_e=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_engine_caching_and_lru_eviction_rebuild():
    reg = GraphRegistry(capacity=1, device="cpu")
    road = port("road_grid", 12, seed=5)
    reg.register("road", road)
    reg.register("kron", port("kronecker", 7, 6, seed=2))
    assert set(reg.gids) == {"road", "kron"}
    e1 = reg.engine("road")
    assert reg.engine("road") is e1               # cache hit
    assert reg.stats.hits == 1 and reg.stats.builds == 1
    reg.engine("kron")                            # evicts road
    assert reg.cached_keys() == (("kron", "segment_min", None),)
    assert reg.stats.evictions == 1
    e2 = reg.engine("road")                       # transparent rebuild
    assert e2 is not e1 and reg.stats.builds == 3
    d_ref, _, _ = sssp(road, 0, device="cpu")
    dist, _, _ = e2.run_batch([0, 0])
    assert dist[0].equal(d_ref)
    assert reg.stats.as_dict()["hit_rate"] == pytest.approx(1 / 4)


@pytest.mark.parametrize("backend,goal,gp", [
    ("segment_min", "tree", None), ("segment_min", "bounded", [2.5, 1.5, 2.5]),
    ("blocked_pallas", "p2p", [100, 30, 100]),
    ("blocked_pallas", "knear", [5, 3, 5])])
def test_engine_batches_match_the_reference(backend, goal, gp):
    """A goal kind's batch on one engine, bitwise the reference
    registry's engine on the same graph (slot 0 repeated as padding)."""
    rg, hg = graph("road_grid", 12, seed=5)
    ref = RefRegistry(capacity=2, **BLOCKED)
    ref.register("road", rg)
    reg = GraphRegistry(capacity=2, device="cpu", **BLOCKED)
    reg.register("road", hg)
    re, pe = ref.engine("road", backend), reg.engine("road", backend)
    assert pe.device == CPU and pe.g.device == CPU
    same_batch(pe.run_batch([0, 5, 0], goal=goal, goal_params=gp),
               re.run_batch([0, 5, 0], goal=goal, goal_params=gp),
               f"{backend} {goal}")


def test_registry_keys_per_backend_and_factory_spec():
    reg = GraphRegistry(capacity=4, device="cpu", **BLOCKED)
    builds = []

    def factory():
        builds.append(1)
        return port("road_grid", 12, seed=5)

    reg.register("road", factory)
    e_seg = reg.engine("road", "segment_min")
    e_blk = reg.engine("road", "blocked")
    assert e_seg is not e_blk and len(builds) == 2
    assert set(reg.cached_keys()) == {("road", "segment_min", None),
                                      ("road", "blocked_pallas", None)}
    d1, _, _ = e_seg.run_batch([3, 7])
    d2, _, m2 = e_blk.run_batch([3, 7])
    assert d1.equal(d2) and bool((m2.n_tiles_scanned > 0).all())
    assert e_blk.layout.tile_e == 64


def test_register_replaces_and_validates():
    reg = GraphRegistry(capacity=2, device="cpu")
    reg.register("g", port("road_grid", 12, seed=5))
    reg.engine("g")
    reg.register("g", port("road_grid", 12, seed=6))
    assert reg.cached_keys() == ()
    with pytest.raises(TypeError):
        reg.register("bad", object())
    with pytest.raises(KeyError):
        reg.engine("missing")
    with pytest.raises(ValueError):
        GraphRegistry(capacity=0)
    with pytest.raises(ValueError):
        reg.register("bad_tier", port("road_grid", 12, seed=5), tier="mesh")


def test_cold_build_does_not_serialize_other_lookups():
    reg = GraphRegistry(capacity=4, device="cpu")
    reg.register("fast", port("road_grid", 8, seed=5))
    reg.engine("fast")
    entered = threading.Event()

    def slow_factory():
        entered.set()
        time.sleep(0.8)
        return port("road_grid", 8, seed=6)

    reg.register("slow", slow_factory)
    builder = threading.Thread(target=lambda: reg.engine("slow"))
    builder.start()
    assert entered.wait(timeout=5)
    t0 = time.perf_counter()
    assert reg.engine("fast") is not None
    waited = time.perf_counter() - t0
    builder.join(timeout=30)
    assert not builder.is_alive()
    assert waited < 0.4, f"built-engine lookup waited {waited:.2f}s"


def test_concurrent_same_key_lookups_share_one_build():
    reg = GraphRegistry(capacity=2, device="cpu")
    builds = []

    def factory():
        builds.append(1)
        time.sleep(0.3)
        return port("road_grid", 8, seed=5)

    reg.register("g", factory)
    out = []
    threads = [threading.Thread(target=lambda: out.append(reg.engine("g")))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(builds) == 1 and out[0] is out[1] is out[2]
    assert reg.stats.builds == 1 and reg.stats.build_waits == 2


def test_reregister_mid_build_serves_new_spec_not_stale_engine():
    reg = GraphRegistry(capacity=2, device="cpu")
    entered, release = threading.Event(), threading.Event()

    def slow_old():
        entered.set()
        release.wait(timeout=5)
        return port("road_grid", 8, seed=5)           # n = 64

    reg.register("g", slow_old)
    old = []
    builder = threading.Thread(target=lambda: old.append(reg.engine("g")))
    builder.start()
    assert entered.wait(timeout=5)
    reg.register("g", port("road_grid", 10, seed=6))  # n = 100
    release.set()
    eng = reg.engine("g")
    builder.join(timeout=30)
    assert eng.n == 100 and reg.peek("g").n == 100 and old[0].n == 64


def test_failed_build_raises_everywhere_and_allows_retry():
    reg = GraphRegistry(capacity=2, device="cpu")
    boom = [True]

    def factory():
        if boom[0]:
            raise RuntimeError("transient build failure")
        return port("road_grid", 8, seed=5)

    reg.register("g", factory)
    with pytest.raises(RuntimeError):
        reg.engine("g")
    boom[0] = False
    assert reg.engine("g") is not None


def test_sharded_tier_raises_naming_item_10(gloo_one):
    """Tiers resolve as in the reference, and a sharded-tier gid (by
    threshold or forced) is served by a ShardedGraphEngine over the
    process group: its batches bitwise the reference's sharded engine
    and the single tier's, its key the reference's."""
    reg = GraphRegistry(capacity=4, shard_threshold_n=100,
                        shard_devices=["cpu"])
    rreg = RefRegistry(capacity=4, shard_threshold_n=100)
    specs = {"big": graph("road_grid", 12, seed=5),          # n = 144
             "small": graph("kronecker", 6, 4, seed=2),     # n = 64
             "forced": graph("kronecker", 6, 4, seed=2)}
    for gid, (rg, hg) in specs.items():
        tier = "sharded" if gid == "forced" else None
        reg.register(gid, hg, tier=tier)
        rreg.register(gid, rg, tier=tier)
    assert [reg.tier(g) for g in ("big", "small", "forced")] \
        == ["sharded", "single", "sharded"]
    assert isinstance(reg.engine("small"), GraphEngine)
    assert reg.engine("small").device == CPU
    for gid in ("big", "forced"):
        eng = reg.engine(gid)
        assert isinstance(eng, ShardedGraphEngine) and eng.tier == "sharded"
        assert eng.device == CPU and eng.n == specs[gid][1].n
        single = GraphEngine(gid, specs[gid][1], "segment_min", 3.0, 0.9,
                             device="cpu")
        for goal, gp in (("tree", None), ("knear", [5, 9])):
            out = eng.run_batch([0, 7], goal=goal, goal_params=gp)
            assert out[0].shape == (2, eng.n)
            same_batch(out, rreg.engine(gid).run_batch(
                np.array([0, 7], np.int32), goal=goal, goal_params=gp),
                f"{gid} {goal} vs the reference")
            want = single.run_batch([0, 7], goal=goal, goal_params=gp)
            same_batch(out, want, f"{gid} {goal} vs the single tier")
    assert reg.peek("big") is reg.engine("big")
    assert ("big", "segment_min", "sharded") in reg.cached_keys()
    assert reg.engine("big", "blocked").blocked is not None


def test_placement_keys_and_the_card_default():
    """A lookup with a device keys its engine by that device; without one
    the engine lands on the registry's device, which defaults to the
    config's first pinned device, else the card (never the CPU)."""
    reg = GraphRegistry(capacity=4, config=EngineConfig(devices=("cpu",)))
    reg.register("g", port("road_grid", 8, seed=5))
    assert reg.engine("g").device == CPU
    e = reg.engine("g", device=CPU)
    assert reg.engine("g", device="cpu") is e
    assert set(reg.cached_keys()) == {("g", "segment_min", None),
                                      ("g", "segment_min", ("dev", "cpu"))}
    bare = GraphRegistry(capacity=1)
    bare.register("g", port("road_grid", 8, seed=5))
    if torch.cuda.is_available():
        assert bare.engine("g").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bare.engine("g")


def test_warmup_prepays_builds():
    reg = GraphRegistry(capacity=4, device="cpu")
    reg.register("road", port("road_grid", 10, seed=5))
    rows = reg.warmup(kinds=("tree", "p2p"), batch_sizes=(2,))
    assert [r["kind"] for r in rows] == ["tree", "p2p"]
    assert rows[0]["build_s"] > 0 and rows[1]["build_s"] == 0
    assert all(r["batch"] == 2 and r["tier"] == "single" for r in rows)
    assert reg.stats.builds == 1
    with pytest.raises(ValueError):
        reg.warmup(kinds=("nope",))


def test_feedback_blends_measured_rounds_into_batch_hint():
    reg = GraphRegistry(capacity=2, device="cpu")
    reg.register("road", port("road_grid", 10, seed=5))
    eng = reg.engine("road")
    assert eng.peek_batch_hint() is None          # no BFS paid yet
    base = eng.batch_hint.copy()
    np.testing.assert_array_equal(base, eng.ecc_hint)
    eng.record_rounds([3, 7], [40.0, 10.0], gamma=0.5)
    assert eng.batch_hint[3] == pytest.approx(0.5 * base[3] + 0.5 * 40.0)
    assert eng.batch_hint[7] == pytest.approx(0.5 * base[7] + 0.5 * 10.0)
    untouched = np.ones(base.shape, bool)
    untouched[[3, 7]] = False
    np.testing.assert_array_equal(eng.batch_hint[untouched],
                                  base[untouched])
    np.testing.assert_array_equal(eng.ecc_hint, base)


def _disconnected():
    from repro.core.graph import build_csr
    from repro_torch import convert
    from test_torch_graph import ref_arrays
    a = graph("kronecker", 7, 8, seed=3)[0]
    m = a.src < a.dst
    g = build_csr(2 * a.n, np.concatenate([a.src[m], a.src[m] + a.n]),
                  np.concatenate([a.dst[m], a.dst[m] + a.n]),
                  np.concatenate([a.w[m], a.w[m]]))
    return g, convert.from_reference(ref_arrays(g), "cpu")


@pytest.mark.parametrize("case", ["road", "kron", "kron-1", "landmarks",
                                  "disconnected", "tiny"])
def test_eccentricity_hint_matches_the_reference(case):
    kw = {}
    if case == "road":
        rg, hg = graph("road_grid", 14, seed=5)
    elif case == "tiny":
        rg, hg = graph("road_grid", 2, seed=0)
        kw = dict(n_landmarks=16)
    elif case == "disconnected":
        rg, hg = _disconnected()
    else:
        rg, hg = graph("kronecker", 8, 8, seed=2)
        kw = {"kron-1": dict(n_landmarks=1),
              "landmarks": dict(landmarks=[3, 9, 40])}.get(case, {})
    got = estimate_eccentricity(hg, **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref_ecc(rg, **kw))
    with pytest.raises(ValueError):
        estimate_eccentricity(hg, n_landmarks=0)


def test_generation_counter_and_listeners():
    reg = GraphRegistry(capacity=4, device="cpu")
    g2 = port("road_grid", 10, seed=9)
    events = []
    reg.add_invalidation_listener(lambda gid, gen: events.append((gid, gen)))
    reg.register("road", port("road_grid", 10, seed=5))
    assert reg.generation("road") == 1 and events == []
    eng1 = reg.engine("road")
    assert eng1.generation == 1
    reg.register("road", g2)
    assert reg.generation("road") == 2 and events == [("road", 2)]
    eng2 = reg.engine("road")
    assert eng2 is not eng1 and eng2.generation == 2
    assert eng2.run_batch([0, 0])[0][0].equal(sssp(g2, 0, device="cpu")[0])
    with pytest.raises(KeyError):
        reg.generation("nope")


def test_landmark_disk_cache_is_shared_with_the_reference(tmp_path):
    """An ALT registry saves its landmark set under the reference's file
    name (gid + graph fingerprint + parameters) in the reference's
    format: a port registry loads the reference's file, and a reference
    registry the port's, both without a build."""
    rg, hg = graph("kronecker", 8, 6, seed=4)
    ref = RefRegistry(capacity=2, use_alt=True, n_landmarks=4,
                      landmark_dir=tmp_path / "ref")
    ref.register("kg", rg)
    want = ref.landmark_set("kg")
    reg = GraphRegistry(capacity=2, use_alt=True, n_landmarks=4,
                        landmark_dir=tmp_path / "ref", device="cpu")
    reg.register("kg", hg)
    eng = reg.engine("kg")
    assert reg._lm_disk["loads"].value == 1
    assert reg._lm_disk["saves"].value == 0
    assert eng.landmarks.generation == 1
    np.testing.assert_array_equal(eng.landmarks.D.numpy(),
                                  np.asarray(want.D))
    np.testing.assert_array_equal(eng.landmarks.landmarks, want.landmarks)
    assert reg.landmark_set("kg") is reg.landmark_set("kg")   # cached
    # the port writes a file the reference loads
    reg2 = GraphRegistry(capacity=2, use_alt=True, n_landmarks=4,
                         landmark_dir=tmp_path / "port", device="cpu")
    reg2.register("kg", hg)
    built = reg2.landmark_set("kg")
    assert reg2._lm_disk["saves"].value == 1
    ref2 = RefRegistry(capacity=2, use_alt=True, n_landmarks=4,
                       landmark_dir=tmp_path / "port")
    ref2.register("kg", rg)
    loaded = ref2.landmark_set("kg")
    assert ref2._lm_disk["loads"].value == 1
    np.testing.assert_array_equal(np.asarray(loaded.D), built.D.numpy())


def _deltas(rg, hg, seed):
    rng = np.random.default_rng(seed)
    und = np.flatnonzero(rg.src < rg.dst)
    pick = rng.choice(und, 12, replace=False)
    rem = [(int(rg.src[e]), int(rg.dst[e])) for e in pick[:4]]
    rew = [(int(rg.src[e]), int(rg.dst[e]),
            float(np.float32(rng.uniform(0.5, 2.0)))) for e in pick[4:8]]
    add = [(int(u), int(v), float(np.float32(rng.uniform(0.05, 2.0))))
           for u, v in rng.integers(0, rg.n, (4, 2)) if u != v]
    kw = dict(add=add, remove=rem, reweight=rew)
    return RefDelta(**kw), EdgeDelta(**kw)


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
def test_apply_delta_matches_the_reference(backend):
    """Both registries patch their cached engines, repair their cached
    trees and report the same; the repaired trees are bitwise the
    reference's and a from-scratch solve's, the patched engines' batches
    the reference's, and the engine a batch was running on is left as
    it was."""
    rg, hg = graph("road_grid", 12, seed=5)
    ref = RefRegistry(capacity=4, backend=backend, **BLOCKED)
    reg = GraphRegistry(capacity=4, backend=backend, device="cpu",
                        **BLOCKED)
    for r, g in ((ref, rg), (reg, hg)):
        r.register("road", g)
        r.engine("road")
    old = reg.engine("road")
    old_w = old.layout.w.clone() if backend == "blocked" else old.g.w.clone()
    for s in (0, 77):
        d, p, _ = ref.engine("road").run_batch([s])
        ref.cache_result("road", s, np.asarray(d)[0], np.asarray(p)[0])
        d, p, _ = reg.engine("road").run_batch([s])
        reg.cache_result("road", s, d[0], p[0])
    rd, pdelta = _deltas(rg, hg, seed=5)
    want = ref.apply_delta("road", rd)
    got = reg.apply_delta("road", pdelta)
    for key in ("n_edits", "engines_patched", "results_repaired",
                "delta_frac", "landmarks"):
        assert got[key] == want[key], key
    new = got["host"]
    for s in (0, 77):
        d2, p2 = reg.cached_result("road", s)
        rd2, rp2 = ref.cached_result("road", s)
        np.testing.assert_array_equal(d2.view(np.int32), rd2.view(np.int32))
        np.testing.assert_array_equal(p2, rp2)
        d0, p0, _ = sssp(new, s, device="cpu")
        assert np.array_equal(d2, d0.numpy())
        assert np.array_equal(p2, p0.numpy())
    eng = reg.engine("road")
    assert eng is not old and reg.stats.builds == 1
    same_batch(eng.run_batch([0, 9]), ref.engine("road").run_batch([0, 9]),
               "patched engine")
    if backend == "blocked":
        ref_layout = build_blocked(new.to_device("cpu"), **BLOCKED)
        assert eng.layout.w.equal(ref_layout.w)
        assert all(a.equal(b) for a, b in zip(eng.layout.index,
                                                ref_layout.index))
        assert old.layout.w.equal(old_w)
    else:
        assert old.g.w.equal(old_w)
    assert reg.delta_frac("road") == pytest.approx(got["delta_frac"])


def test_apply_delta_keeps_or_drops_landmarks_as_the_reference():
    """An increase/remove-only delta within the staleness budget keeps
    the gid's landmark set, marked stale; an addition drops it."""
    rg, hg = graph("kronecker", 7, 6, seed=2)
    for adds, want in ((False, "stale"), (True, "dropped")):
        reg = GraphRegistry(capacity=2, use_alt=True, n_landmarks=4,
                            delta_staleness_budget=0.5, device="cpu")
        reg.register("kg", hg)
        reg.engine("kg")
        u, v = int(hg.src[0]), int(hg.dst[0])
        delta = EdgeDelta(reweight=[(u, v, float(hg.w[0]) * 2)],
                          add=[(0, hg.n - 1, 1.0)] if adds else ())
        assert reg.apply_delta("kg", delta)["landmarks"] == want
        lm = reg.engine("kg").landmarks
        assert (lm is not None and lm.stale) == (want == "stale")
    with pytest.raises(KeyError):
        reg.apply_delta("nope", delta)
    with pytest.raises(KeyError):
        reg.cache_result("nope", 0, np.zeros(3), np.zeros(3))
    assert reg.cached_result("kg", 123) is None


def test_result_cache_is_lru_per_gid():
    reg = GraphRegistry(capacity=2, result_cache_capacity=2, device="cpu")
    reg.register("g", port("road_grid", 8, seed=5))
    for s in (1, 2, 3):
        reg.cache_result("g", s, np.full(64, s, np.float32),
                         np.zeros(64, np.int32))
    assert reg.cached_result("g", 1) is None
    assert reg.cached_result("g", 3)[0][0] == 3
    with pytest.raises(ValueError):
        GraphRegistry(result_cache_capacity=0)
