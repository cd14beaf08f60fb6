"""Port parity: the router (``repro_torch.serve.router``).

Mirrors ``tests/test_router.py`` on the CPU, with two scheduler entries
on one device (``[torch.device("cpu")] * 2`` where the reference repeats
``jax.devices()[0]``): placement and stickiness, replicas, hot-graph
replication, replica decay, load shedding, warmup, re-register
rebuilds, and the mesh scheduler serving a sharded-tier gid (at one
gloo rank), deltas included.  Routed answers are held bitwise
against the reference router's.  The routed tier of the facade is in
``tests/test_torch_routed.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.delta import EdgeDelta as RefDelta
from repro.serve.queries import Query as RefQuery
from repro.serve.registry import GraphRegistry as RefRegistry
from repro.serve.router import QueryRouter as RefRouter
from repro_torch.api import EngineConfig
from repro_torch.core.sssp import sssp
from repro_torch.delta import EdgeDelta
from repro_torch.serve.queries import Query
from repro_torch.serve.registry import GraphRegistry
from repro_torch.serve.router import QueryRouter
from repro_torch.serve.scheduler import QueueFull
from torch_serve_common import cpus, gloo_one, graph, port, same_answer
from release_xla import release_compiled  # noqa: F401

SIDE = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def two_graph_registry(side=8, **kw):
    """Two graphs for the routing logic (small: the logic does not look
    at them, each batch solves them)."""
    reg = GraphRegistry(capacity=8, device="cpu", **kw)
    reg.register("road", port("road_grid", side, seed=5))
    reg.register("kron", port("kronecker", 6, 6, seed=2))
    return reg


def test_routed_answers_match_the_reference_router():
    """The same mixed queries on two graphs through both routers (two
    scheduler entries each): the same placement, every answer bitwise."""
    ref = RefRegistry(capacity=8)
    reg = two_graph_registry(side=SIDE)
    for gid, args in (("road", ("road_grid", SIDE)), ("kron",
                                                      ("kronecker", 6, 6))):
        ref.register(gid, graph(*args, seed=5 if gid == "road" else 2)[0])
    import jax
    rr = RefRouter(ref, devices=[jax.devices()[0]] * 2, max_batch=2)
    pr = QueryRouter(reg, devices=cpus(2), max_batch=2)
    qs = [dict(gid="road", source=0), dict(gid="kron", source=3),
          dict(gid="road", source=9, kind="p2p", target=100),
          dict(gid="kron", source=1, kind="knear", k=6),
          dict(gid="road", source=40, kind="bounded", bound=2.0)]
    rf = [rr.submit(RefQuery(**q)) for q in qs]
    pf = [pr.submit(Query(**q)) for q in qs]
    rr.drain()
    pr.drain()
    for q, a, b in zip(qs, pf, rf):
        ra, rb = a.result(timeout=0), b.result(timeout=0)
        same_answer(ra, rb, q)
        assert ra.served_by == rb.served_by, q
    assert pr.stats()["placement"] == rr.stats()["placement"]


def test_placement_stickiness_and_spread():
    reg = two_graph_registry()
    router = QueryRouter(reg, devices=cpus(2), max_batch=2)
    futs = [router.submit(Query(gid="road", source=s)) for s in (0, 5, 9)]
    futs += [router.submit(Query(gid="kron", source=s)) for s in (1, 2)]
    router.drain()
    road_by = {f.result(timeout=0).served_by for f in futs[:3]}
    kron_by = {f.result(timeout=0).served_by for f in futs[3:]}
    assert len(road_by) == 1 and len(kron_by) == 1 and road_by != kron_by
    st = router.stats()
    assert st["n_routed"] == 5 and st["n_done"] == 5
    assert set(st["placement"]) == {"road", "kron"}
    assert st["n_devices"] == 2 and st["rejected"] == 0


def test_replicas_route_to_least_loaded():
    reg = two_graph_registry()
    router = QueryRouter(reg, devices=cpus(2), max_batch=2)
    router.plan_placement({"road": 1.0})
    assert sorted(router.stats()["placement"]["road"]) == ["dev0", "dev1"]
    futs = [router.submit(Query(gid="road", source=s)) for s in (0, 1, 2, 3)]
    router.drain()
    assert {f.result(timeout=0).served_by for f in futs} == {"dev0", "dev1"}
    # one device twice: both entries share one engine
    assert reg.cached_keys() == (("road", "segment_min", ("dev", "cpu")),)
    with pytest.raises(ValueError):
        router.plan_placement({"road": 0.0})


def test_hot_graph_replication_triggers():
    reg = two_graph_registry()
    router = QueryRouter(reg, devices=cpus(2), max_batch=2,
                         replicate_factor=2.0, replicate_min_depth=4)
    futs = [router.submit(Query(gid="road", source=s % 100))
            for s in range(12)]
    st = router.stats()
    assert st["n_replications"] >= 1 and len(st["placement"]["road"]) == 2
    router.drain()
    assert {f.result(timeout=0).served_by for f in futs} == {"dev0", "dev1"}


def test_sharded_tier_goes_to_the_mesh_scheduler_and_raises(gloo_one):
    """A sharded-tier gid is routed to the "mesh" scheduler, as in the
    reference, and served by its ShardedGraphEngine: the answers are the
    reference router's, and ``apply_delta`` patches the sharded engine in
    place (no rebuild) with the reference's answers after it."""
    rg_big, hg_big = graph("road_grid", SIDE, seed=5)
    rg_small, hg_small = graph("kronecker", 6, 4, seed=2)
    reg = GraphRegistry(capacity=4, shard_threshold_n=100,
                        shard_devices=["cpu"])
    rreg = RefRegistry(capacity=4, shard_threshold_n=100)
    for gid, rg, hg in (("big", rg_big, hg_big),
                        ("small", rg_small, hg_small)):
        reg.register(gid, hg)
        rreg.register(gid, rg)
    router = QueryRouter(reg, devices=cpus(2), max_batch=2)
    rrouter = RefRouter(rreg, devices=[jax.devices()[0]] * 2, max_batch=2)
    assert router.mesh_scheduler.name == "mesh"
    queries = [dict(gid="big", source=0, kind="p2p", target=100),
               dict(gid="big", source=7, kind="knear", k=9),
               dict(gid="small", source=1)]

    def serve():
        futs = [router.submit(Query(**q)) for q in queries]
        rfuts = [rrouter.submit(RefQuery(**q)) for q in queries]
        router.drain()
        rrouter.drain()
        return ([f.result(timeout=0) for f in futs],
                [f.result(timeout=0) for f in rfuts])
    got, want = serve()
    for q, a, b in zip(queries, got, want):
        same_answer(a, b, str(q))
    assert [r.served_by for r in got[:2]] == ["mesh", "mesh"]
    assert got[2].served_by != "mesh"
    assert "big" not in router.stats()["placement"]
    rows = router.warmup(["big"])
    assert rows and {r["scheduler"] for r in rows} == {"mesh"}
    assert {r["tier"] for r in rows} == {"sharded"}
    # a delta on the sharded gid: the engine is patched, not rebuilt
    und = np.flatnonzero(rg_big.src < rg_big.dst)[:6]
    edits = [(int(rg_big.src[e]), int(rg_big.dst[e])) for e in und]
    builds = reg.stats.builds
    report = reg.apply_delta("big", EdgeDelta(remove=edits[:3],
                                              reweight=[(u, v, 0.25) for u, v
                                                        in edits[3:]]))
    rreg.apply_delta("big", RefDelta(remove=edits[:3],
                                     reweight=[(u, v, 0.25) for u, v
                                               in edits[3:]]))
    assert report["engines_patched"] == 1 and reg.stats.builds == builds
    got, want = serve()
    for q, a, b in zip(queries, got, want):
        same_answer(a, b, f"after the delta {q}")


def test_router_load_shedding_is_per_device():
    reg = two_graph_registry()
    router = QueryRouter(reg, devices=cpus(2), max_batch=2, max_pending=2)
    for s in (0, 1):
        router.submit(Query(gid="road", source=s))
    with pytest.raises(QueueFull):
        router.submit(Query(gid="road", source=2))
    router.submit(Query(gid="kron", source=0))
    assert router.stats()["rejected"] == 1
    router.drain()


def test_warmup_builds_replicas():
    reg = two_graph_registry()
    router = QueryRouter(reg, devices=cpus(2), max_batch=2)
    router.plan_placement({"road": 3.0, "kron": 1.0})
    rows = router.warmup(kinds=("tree", "p2p"))
    assert len(rows) == 6
    assert {r["scheduler"] for r in rows if r["gid"] == "road"} \
        == {"dev0", "dev1"}
    builds = reg.stats.builds
    fut = router.submit(Query(gid="road", source=0, kind="p2p", target=9))
    router.drain()
    assert fut.result(timeout=0).distance is not None
    assert reg.stats.builds == builds


def test_unknown_gid_fails_future_not_router():
    reg = two_graph_registry()
    router = QueryRouter(reg, devices=cpus(2), max_batch=2)
    bad = router.submit(Query(gid="nope", source=0))
    ok = router.submit(Query(gid="road", source=1))
    router.drain()
    with pytest.raises(KeyError):
        bad.result(timeout=0)
    assert ok.result(timeout=0).dist is not None
    assert "nope" not in router.stats()["placement"]


def test_devices_default_to_the_visible_cards():
    """With no devices given the router takes every visible CUDA device;
    with none visible it raises rather than pick the CPU."""
    reg = two_graph_registry()
    if torch.cuda.is_available():
        assert QueryRouter(reg).n_devices == torch.cuda.device_count()
    else:
        with pytest.raises(ValueError, match="no CUDA device"):
            QueryRouter(reg)
        with pytest.raises(ValueError, match="no CUDA device"):
            QueryRouter(reg, config=EngineConfig())
    with pytest.raises(ValueError):
        QueryRouter(reg, devices=cpus(1), replicate_factor=0.5)
    with pytest.raises(ValueError):
        QueryRouter(reg, devices=cpus(1), decay_windows=0)


def test_reregister_rebuilds_placed_replicas_eagerly():
    g2 = port("road_grid", SIDE, seed=9)
    reg = GraphRegistry(capacity=8, device="cpu")
    reg.register("road", port("road_grid", SIDE, seed=5))
    router = QueryRouter(reg, devices=cpus(2))
    f = router.submit(Query(gid="road", source=0))
    router.drain()
    assert f.result().dist is not None
    builds0 = reg.stats.builds
    reg.register("road", g2)
    assert router.stats()["n_rebuilds"] == 1
    assert reg.stats.builds == builds0 + 1
    eng = reg.peek("road", device=router.devices[0])
    assert eng is not None and eng.generation == 2
    hits0 = reg.stats.hits
    f2 = router.submit(Query(gid="road", source=0))
    router.drain()
    np.testing.assert_array_equal(f2.result().dist,
                                  sssp(g2, 0, device="cpu")[0].numpy())
    assert reg.stats.hits > hits0
    reg.register("fresh", port("road_grid", SIDE, seed=3))
    reg.register("fresh", port("road_grid", SIDE, seed=4))
    assert router.stats()["n_rebuilds"] == 1


# -- replica decay ----------------------------------------------------------

def test_replica_decay_shrinks_cold_placement():
    reg = two_graph_registry()
    router = QueryRouter(reg, devices=cpus(2), max_batch=2,
                         decay_window=8, decay_windows=2, decay_share=0.0)
    router.plan_placement({"road": 1.0})
    router.plan_placement({"kron": 1.0})
    for s in range(4):
        router.submit(Query(gid="road", source=s))
        router.submit(Query(gid="road", source=s + 50))
        router.drain()
    for s in range(16):
        router.submit(Query(gid="road", source=s % 100))
        router.drain()
    st = router.stats()
    assert st["n_decays"] >= 1 and st["placement"]["road"] == ["dev0"]
    assert sorted(st["placement"]["kron"]) == ["dev0", "dev1"]
    fut = router.submit(Query(gid="road", source=3))
    router.drain()
    assert fut.result(timeout=0).served_by == "dev0"


@pytest.mark.parametrize("case", ["planned", "disabled"])
def test_replicas_that_do_not_decay(case):
    """Planned replicas are protected until their traffic arrives, and
    ``decay_window=0`` turns decay off."""
    reg = two_graph_registry()
    kw = (dict(decay_window=8, decay_windows=2, decay_share=0.0)
          if case == "planned" else dict(decay_window=0))
    router = QueryRouter(reg, devices=cpus(2), max_batch=2, **kw)
    router.plan_placement({"road": 1.0})
    for s in range(32 if case == "planned" else 12):
        router.submit(Query(gid="road", source=s % 100))
        router.drain()
    st = router.stats()
    assert st["n_decays"] == 0
    assert sorted(st["placement"]["road"]) == ["dev0", "dev1"]


def test_decay_min_traffic_gates_decay():
    reg = two_graph_registry()
    router = QueryRouter(reg, devices=cpus(2), max_batch=2,
                         decay_window=8, decay_windows=1, decay_share=0.0,
                         decay_min_traffic=9)
    with router._lock:
        router._placement["road"] = [0, 1]
        router._n_placed[0] += 1
        router._n_placed[1] += 1
    for s in range(8):
        router.submit(Query(gid="road", source=s))
        router.drain()
    assert router.stats()["n_decays"] == 0
    router.decay_min_traffic = 1
    for s in range(8):
        router.submit(Query(gid="road", source=s))
        router.drain()
    st = router.stats()
    assert st["n_decays"] == 1 and st["placement"]["road"] == ["dev0"]
