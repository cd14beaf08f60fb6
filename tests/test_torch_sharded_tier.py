"""Port parity: the sharded tier of the serving plane, the facade and the
tuner (``ShardedGraphEngine``, the router's mesh scheduler,
``Solver(EngineConfig(tier="sharded"))``, ``tune`` on a sharded base).

At one gloo rank in process, every answer is bitwise the single tier's
(dist, parent, the logical counters):

* a ``ShardedGraphEngine`` batch at v2 and v3 on both backends, ALT p2p
  with the registry's landmark set included;
* the router's mesh scheduler on a blocked sharded gid, a cached tree
  repaired by ``apply_delta`` and the queries after it;
* ``Solver`` sessions on the sharded tier (every kind, scalar and
  batched, ``solve_many``, ``use_alt``, traces);
* a tune on a segment_min sharded base: the single tier's trajectory on
  the same axes (the objective reads logical counters only there).

Over 2 gloo ranks (child processes): rank 0 serves queries through a
scheduler while rank 1 runs ``GraphRegistry.follow``, an ``apply_delta``
reaches the follower, an ``apply_delta`` races a scheduler worker's
queries, and a ``Solver`` on the sharded tier solves on both ranks; rank
0's answers are held against the single tier's.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.api import EngineConfig, SolveSpec, Solver
from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict
from repro_torch.delta import EdgeDelta
from repro_torch.serve.queries import Query
from repro_torch.serve.registry import (GraphEngine, GraphRegistry,
                                        ShardedGraphEngine)
from repro_torch.serve.router import QueryRouter
from repro_torch.serve.scheduler import QueryScheduler
from repro_torch.tune import tune
from torch_serve_common import (LOGICAL_KEYS, cpus, gloo_one, graph, port,
                                same_answer, same_batch)

SIDE = 12
BLOCKED = dict(block_v=64, tile_e=64)
SRC = Path(__file__).resolve().parents[1] / "src"
CHILD_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _registry(**kw):
    reg = GraphRegistry(capacity=4, shard_threshold_n=100,
                        shard_devices=["cpu"], **kw)
    reg.register("road", port("road_grid", SIDE, seed=5))
    return reg


@pytest.mark.parametrize("goal", ["tree", "p2p", "knear"])
@pytest.mark.parametrize("version", ["v2", "v3"])
@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
def test_sharded_engine_batch_is_the_single_tiers(backend, version, goal,
                                                  gloo_one):
    cfg = EngineConfig(shard_threshold_n=100, shard_version=version,
                       shard_backend=backend, use_alt=goal == "p2p",
                       n_landmarks=4, devices=("cpu",),
                       **(BLOCKED if backend == "blocked" else {}))
    reg = GraphRegistry(capacity=4, config=cfg)
    hg = port("road_grid", SIDE, seed=5)
    reg.register("road", hg)
    eng = reg.engine("road")
    assert isinstance(eng, ShardedGraphEngine) and eng.version == version
    assert (eng.blocked is not None) == (backend == "blocked")
    srcs = [0, 7, 50]
    gps = {"tree": None, "p2p": [100, 3, 143], "knear": [5, 1, 20]}[goal]
    single = GraphEngine("road", hg, "segment_min", 3.0, 0.9,
                         device="cpu",
                         landmarks=eng.landmarks)
    got = eng.run_batch(srcs, goal=goal, goal_params=gps)
    if goal == "p2p":
        # ALT: the registry's landmark set, the single tier's counters
        assert eng.landmarks is not None
        assert int(got[2].n_pruned.sum()) > 0
    same_batch(got, single.run_batch(srcs, goal=goal, goal_params=gps),
               f"{backend} {version} {goal}")


def test_mesh_scheduler_serves_a_blocked_sharded_gid_with_deltas(gloo_one):
    """The router's mesh scheduler on a blocked sharded gid: answers the
    single tier's; ``apply_delta`` patches the sharded engine (its slabs
    and blocked layout) in place, repairs the cached tree, and the
    answers after it are the single tier's on the patched graph."""
    reg = _registry(shard_backend="blocked", **BLOCKED)
    single = GraphRegistry(capacity=4, device="cpu")
    single.register("road", port("road_grid", SIDE, seed=5))
    router = QueryRouter(reg, devices=cpus(1), max_batch=2)
    sch = QueryScheduler(single, max_batch=2)
    qs = [dict(gid="road", source=0), dict(gid="road", source=9,
                                              kind="p2p", target=100),
          dict(gid="road", source=3, kind="bounded", bound=1.5)]

    def serve():
        futs = [router.submit(Query(**q)) for q in qs]
        want = [sch.submit(Query(**q)) for q in qs]
        router.drain()
        sch.drain()
        for q, a, b in zip(qs, futs, want):
            a = a.result(timeout=0)
            assert a.served_by == "mesh"
            same_answer(a, b.result(timeout=0), str(q))
        return futs[0].result(timeout=0)
    tree = serve()
    reg.cache_result("road", 0, tree.dist, tree.parent)
    rg = graph("road_grid", SIDE, seed=5)[0]
    und = np.flatnonzero(rg.src < rg.dst)[::17][:6]
    edits = [(int(rg.src[e]), int(rg.dst[e])) for e in und]
    delta = EdgeDelta(remove=edits[:3], reweight=[(u, v, 0.3)
                                                  for u, v in edits[3:]])
    eng = reg.engine("road")
    sg, blocked = eng.sg, eng.blocked
    report = reg.apply_delta("road", delta)
    single.apply_delta("road", delta)
    assert report["engines_patched"] == 1 and report["results_repaired"] == 1
    # patched in place: a worker holding the engine sees the new graph
    assert reg.engine("road") is eng and eng.blocked is not blocked
    assert eng.sg.w.tobytes() != sg.w.tobytes()
    after = serve()
    d, p = reg.cached_result("road", 0)
    assert d.tobytes() == after.dist.tobytes()
    assert np.array_equal(p, after.parent)


def _specs(n):
    S = SolveSpec
    return [S.tree(0), S.p2p(0, n - 1), S.bounded(0, 2.5), S.knear(0, 5),
            S.tree([0, 5]), S.p2p([0, 5], [n - 1, 30]),
            S.bounded([0, 5], [2.5, 1.5]), S.knear([0, 5], [5, 3])]


def _same_result(a, b, what):
    assert np.asarray(a.dist).view(np.int32).tobytes() \
        == np.asarray(b.dist).view(np.int32).tobytes(), what
    assert np.array_equal(np.asarray(a.parent), np.asarray(b.parent)), what
    for f in LOGICAL_METRIC_FIELDS:
        assert np.array_equal(np.asarray(getattr(a.metrics, f)),
                              np.asarray(getattr(b.metrics, f))), (what, f)


@pytest.mark.parametrize("cfg", [
    dict(), dict(shard_version="v3", backend="blocked", **BLOCKED),
    dict(shard_version="v1", policy="adaptive"),
    dict(backend="blocked", fused_rounds=4, use_alt=True, n_landmarks=4,
         **BLOCKED)],
    ids=["v2", "v3-blocked", "v1-adaptive", "v2-blocked-fused-alt"])
def test_solver_sharded_tier_matches_the_single_tier(cfg, gloo_one):
    hg = port("road_grid", SIDE, seed=5)
    single_cfg = {k: v for k, v in cfg.items()
                  if k not in ("shard_version", "shard_backend")}
    with Solver.open(hg, EngineConfig(tier="sharded", **cfg),
                     device="cpu") as s, \
            Solver.open(hg, EngineConfig(**single_cfg), device="cpu") as one:
        assert s.tier == "sharded" and s.device_graph is None
        assert (s.landmarks is not None) == cfg.get("use_alt", False)
        for spec in _specs(hg.n):
            res = s.solve(spec)
            assert res.tier == "sharded" and res.dist.shape[-1] == hg.n
            _same_result(res, one.solve(spec), f"{cfg} {spec}")
        many = s.solve_many(_specs(hg.n))
        for spec, res in zip(_specs(hg.n), many):
            _same_result(res, s.solve(spec), f"{cfg} solve_many {spec}")
        assert s.warmup(kinds=("tree", "knear"))


def test_solver_sharded_tier_traces_and_refusals(gloo_one):
    hg = port("road_grid", SIDE, seed=5)
    with Solver.open(hg, EngineConfig(tier="sharded", trace=True,
                                      trace_capacity=64),
                     device="cpu") as s:
        one = s.solve(SolveSpec.tree(0))
        batch = s.solve(SolveSpec.tree([0, 5]))
        assert len(batch.trace) == 2
        assert batch.trace[0].records() == one.trace.records()
        sums = one.trace.counter_sums()
        m = metrics_dict(one.metrics)
        assert sums["n_relax"] == m["n_relax"]
        assert sums["n_rounds"] == m["n_rounds"]
        with pytest.raises(Exception, match="routed"):
            s.apply_delta(EdgeDelta())
    with pytest.raises(Exception, match="layout"):
        Solver.open(hg, EngineConfig(tier="sharded"), device="cpu",
                    layout=hg.to_device("cpu"))


def test_sharded_tier_needs_a_process_group():
    hg = port("road_grid", SIDE, seed=5)
    with pytest.raises(RuntimeError, match="process group"):
        Solver.open(hg, EngineConfig(tier="sharded"), device="cpu")
    reg = _registry()
    with pytest.raises(RuntimeError, match="process group"):
        reg.engine("road")


def test_tune_on_a_sharded_base_is_the_single_tiers(gloo_one):
    """On ``segment_min`` the objective reads logical counters only, so a
    sharded base walks the single tier's trajectory over the axes both
    tiers carry."""
    hg = port("kronecker", 8, 6, seed=4)
    kw = dict(budget=6, seed=0, restarts=1, n_sources=2, device="cpu",
              space={"alpha": (1.5, 3.0, 6.0), "beta": (0.7, 0.9),
                     "policy": ("static", "adaptive")})
    got = tune(hg, EngineConfig(tier="sharded"), **kw)
    want = tune(hg, EngineConfig(), **kw)
    assert len(got.trajectory) == len(want.trajectory) > 1
    for a, b in zip(got.trajectory, want.trajectory):
        assert a == b
    assert got.best_objective == want.best_objective
    assert got.best_config.tier == "sharded"
    assert got.n_parity_rejects == 0


# ---------------------------------------------------------------------------
# two ranks: rank 0 serves, rank 1 follows
# ---------------------------------------------------------------------------

QUERIES = [dict(gid="road", source=0), dict(gid="road", source=7,
                                            kind="knear", k=9),
           dict(gid="road", source=9, kind="p2p", target=100),
           dict(gid="road", source=3, kind="bounded", bound=1.5)]


# the tree queries of the race between a scheduler worker and a delta
RACE = [0, 7, 50, 100, 143, 31]


def _delta_edits():
    rg = graph("road_grid", SIDE, seed=5)[0]
    und = np.flatnonzero(rg.src < rg.dst)[::13][:6]
    edits = [(int(rg.src[e]), int(rg.dst[e])) for e in und]
    return dict(remove=edits[:3], reweight=[(u, v, 0.3) for u, v in
                                            edits[3:]])


_CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as tdist
from repro_torch.api import EngineConfig, SolveSpec, Solver
from repro_torch.core.sssp import metrics_dict
from repro_torch.data import generators
from repro_torch.delta import EdgeDelta
from repro_torch.serve.queries import Query
from repro_torch.serve.registry import GraphRegistry
from repro_torch.serve.scheduler import QueryScheduler
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
spec = json.loads(sys.argv[5])
torch.set_num_threads(1)
tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                         rank=rank, world_size=world)
g = generators.road_grid(spec["side"], seed=5)
devices = ("cpu",) * world

def answer(r):
    return dict(dist=np.asarray(r.dist, np.float32).view(np.int32).tolist(),
                parent=np.asarray(r.parent).tolist(), metrics=r.metrics,
                distance=None if r.distance is None else float(r.distance),
                path=r.path, nearest=None if r.nearest is None else
                [[int(v), float(d)] for v, d in r.nearest],
                served_by=r.served_by)

res = {}
for backend in ("segment_min", "blocked"):
    reg = GraphRegistry(capacity=2, config=EngineConfig(
        shard_threshold_n=1, shard_backend=backend, devices=devices,
        **({"block_v": 64, "tile_e": 64} if backend == "blocked" else {})))
    reg.register("road", g)
    if rank == 0:
        sch = QueryScheduler(reg, max_batch=2)
        def serve():
            futs = [sch.submit(Query(**q)) for q in spec["queries"]]
            sch.drain()
            return [answer(f.result(timeout=0)) for f in futs]
        before = serve()
        reg.apply_delta("road", EdgeDelta(**spec["delta"]))
        after = serve()
        reg.stop_followers()
        res[backend] = dict(before=before, after=after,
                            batches=sch.n_batches)
    else:
        res[backend] = dict(served=reg.follow())
# a delta racing queries: rank 0's scheduler worker serves tree queries
# while the main thread applies the delta; then a batch on the engine
# object taken before the delta, as a worker may hold it
reg = GraphRegistry(capacity=2, config=EngineConfig(
    shard_threshold_n=1, shard_backend="blocked", devices=devices,
    block_v=64, tile_e=64))
reg.register("road", g)
if rank == 0:
    held = reg.engine("road")
    sch = QueryScheduler(reg, max_batch=1)
    sch.start()
    futs = [sch.submit(Query(gid="road", source=s)) for s in spec["race"]]
    reg.apply_delta("road", EdgeDelta(**spec["delta"]))
    futs += [sch.submit(Query(gid="road", source=s)) for s in spec["race"]]
    race = [answer(f.result(timeout=120)) for f in futs]
    sch.stop()
    d, p, _ = held.run_batch(spec["race"][:2])
    reg.stop_followers()
    res["race"] = race
    res["held"] = dict(dist=d.view(torch.int32).tolist(),
                       parent=p.tolist())
else:
    res["race"] = reg.follow()
with Solver.open(g, EngineConfig(tier="sharded", shard_version="v3",
                                 devices=devices)) as s:
    r = s.solve(SolveSpec.knear([0, 5], [5, 9]))
    res["solver"] = dict(dist=r.dist.view(torch.int32).tolist(),
                         parent=r.parent.tolist(),
                         metrics=[metrics_dict(type(r.metrics)(
                             *(x[i] for x in r.metrics))) for i in range(2)])
tdist.destroy_process_group()
with open(out + "." + str(rank), "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("follow")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    spec = json.dumps(dict(side=SIDE, queries=QUERIES, race=RACE,
                           delta=_delta_edits()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(rank), "2", str(tmp / "store"),
         str(tmp / "result"), spec], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        for rank, proc in enumerate(procs):
            try:
                _, err = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} did not finish in "
                            f"{CHILD_TIMEOUT_S} s")
            assert proc.returncode == 0, f"rank {rank}: {err[-3000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [json.loads((tmp / f"result.{rank}").read_text())
            for rank in range(2)]


def _single_answers(delta=None):
    reg = GraphRegistry(capacity=2, device="cpu")
    reg.register("road", port("road_grid", SIDE, seed=5))
    if delta is not None:
        reg.apply_delta("road", EdgeDelta(**delta))
    sch = QueryScheduler(reg, max_batch=2)
    futs = [sch.submit(Query(**q)) for q in QUERIES]
    sch.drain()
    return [f.result(timeout=0) for f in futs]


def _as_result(a: dict):
    return SimpleNamespace(
        dist=np.asarray(a["dist"], np.int32).view(np.float32),
        parent=np.asarray(a["parent"], np.int32), metrics=a["metrics"],
        distance=a["distance"], path=a["path"],
        nearest=None if a["nearest"] is None else
        [(v, np.float32(d)) for v, d in a["nearest"]])


@pytest.mark.parametrize("when", ["before", "after"])
@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
def test_rank_zero_serves_while_rank_one_follows(backend, when, two_ranks):
    rank0, rank1 = two_ranks
    # a header for each batch rank 0 ran and one for the delta
    assert rank1[backend]["served"] == rank0[backend]["batches"] + 1 > 1
    want = _single_answers(None if when == "before" else _delta_edits())
    for q, a, b in zip(QUERIES, rank0[backend][when], want):
        got = _as_result(a)
        b = SimpleNamespace(
            dist=b.dist, parent=b.parent, metrics=b.metrics,
            distance=b.distance, path=b.path,
            nearest=None if b.nearest is None else
            [(int(v), np.float32(d)) for v, d in b.nearest])
        same_answer(got, b, f"{backend} {when} {q}")
        assert a["served_by"] == "default"
        assert {k: a["metrics"][k] for k in LOGICAL_KEYS} \
            == {k: b.metrics[k] for k in LOGICAL_KEYS}


def test_solver_over_two_ranks_is_the_single_tiers(two_ranks):
    rank0, rank1 = two_ranks
    assert rank0["solver"] == rank1["solver"]
    hg = port("road_grid", SIDE, seed=5)
    want = Solver.open(hg, device="cpu").solve(SolveSpec.knear([0, 5],
                                                               [5, 9]))
    got = rank0["solver"]
    assert np.asarray(got["dist"], np.int32).tobytes() \
        == want.dist.view(torch.int32).numpy().tobytes()
    assert got["parent"] == want.parent.tolist()
    for i in range(2):
        m = metrics_dict(type(want.metrics)(*(x[i] for x in want.metrics)))
        assert {f: got["metrics"][i][f] for f in LOGICAL_METRIC_FIELDS} \
            == {f: m[f] for f in LOGICAL_METRIC_FIELDS}


def test_a_delta_racing_queries_keeps_the_ranks_on_one_graph(two_ranks):
    """A delta applied while rank 0's scheduler worker serves queries
    holds the plane lock from its announcement to its swap: every answer
    is the single tier's on the graph before the delta or on the graph
    after it (a batch that solved on rank 0's old shards and rank 1's
    patched ones would match neither), and every query submitted after
    ``apply_delta`` returned sees the patched graph, also through the
    engine object taken before the delta (the engine is patched in
    place)."""
    rank0, rank1 = two_ranks
    assert rank1["race"] == 2 * len(RACE) + 2
    reg = GraphRegistry(capacity=2, device="cpu")
    reg.register("road", port("road_grid", SIDE, seed=5))
    sch = QueryScheduler(reg, max_batch=1)

    def trees():
        futs = [sch.submit(Query(gid="road", source=s)) for s in RACE]
        sch.drain()
        return [f.result(timeout=0) for f in futs]
    before = trees()
    reg.apply_delta("road", EdgeDelta(**_delta_edits()))
    after = trees()
    for i, a in enumerate(rank0["race"]):
        got = _as_result(a)
        want = after[i % len(RACE)]
        if i < len(RACE) and not np.array_equal(
                got.dist.view(np.int32), np.asarray(
                    want.dist, np.float32).view(np.int32)):
            want = before[i]
        same_answer(got, want, f"race query {i}")
    held = rank0["held"]
    for i in range(2):
        assert np.asarray(held["dist"][i], np.int32).tobytes() \
            == np.asarray(after[i].dist, np.float32).view(
                np.int32).tobytes(), f"held engine, source {RACE[i]}"
        assert held["parent"][i] == np.asarray(after[i].parent).tolist()
