"""Port parity: the admission scheduler (``repro_torch.serve.scheduler``).

Mirrors ``tests/test_scheduler.py`` and the scheduler parts of
``tests/test_obs_serving.py`` on the CPU: priority/FIFO order, deadlines
on an injected clock, padding, eccentricity grouping, load shedding,
rounds feedback, the double-buffered worker, the metrics read-through and
a sharded-tier gid (at one gloo rank).  Every served query of each kind
is held bitwise against the reference scheduler's answer to the same
query (dist, parent, the logical metrics, distance, path, nearest).
"""
import time

import numpy as np
import pytest
import torch

from repro.serve.queries import Query as RefQuery
from repro.serve.registry import GraphRegistry as RefRegistry
from repro.serve.scheduler import QueryScheduler as RefScheduler
from repro_torch.core.sssp import sssp
from repro_torch.obs import parse_prometheus, to_prometheus
from repro_torch.serve.queries import Query
from repro_torch.serve.registry import GraphRegistry
from repro_torch.serve.scheduler import (DeadlineExceeded, QueryScheduler,
                                         QueueFull)
from torch_serve_common import gloo_one, graph, port, same_answer
from release_xla import release_compiled  # noqa: F401

SIDE = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeClock:
    """Monotonic fake time: call to read, ``advance`` to move."""

    def __init__(self, start: float = 100.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


@pytest.fixture()
def registry():
    reg = GraphRegistry(capacity=2, device="cpu")
    reg.register("road", port("road_grid", SIDE, seed=5))
    return reg


QUERIES = [dict(source=5), dict(source=17), dict(source=40, kind="p2p",
                                                 target=100),
           dict(source=0, kind="p2p", target=143),
           dict(source=3, kind="bounded", bound=2.5),
           dict(source=77, kind="bounded", bound=1.0),
           dict(source=9, kind="knear", k=5), dict(source=60, kind="knear",
                                                   k=12)]


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
def test_served_queries_match_the_reference(backend):
    """Mixed kinds through both packages' schedulers (max_batch 2, so
    each kind is one batch): every answer bitwise the reference's."""
    rg, hg = graph("road_grid", SIDE, seed=5)
    geom = dict(block_v=64, tile_e=64) if backend == "blocked" else {}
    ref = RefRegistry(capacity=2, backend=backend + (
        "_pallas" if backend == "blocked" else ""), **geom)
    ref.register("road", rg)
    reg = GraphRegistry(capacity=2, backend=backend, device="cpu", **geom)
    reg.register("road", hg)
    rs, ps = (RefScheduler(ref, max_batch=2, ecc_batching=False),
              QueryScheduler(reg, max_batch=2, ecc_batching=False))
    rf = [rs.submit(RefQuery(gid="road", **q)) for q in QUERIES]
    pf = [ps.submit(Query(gid="road", **q)) for q in QUERIES]
    assert rs.drain() == ps.drain() == 4
    for q, a, b in zip(QUERIES, pf, rf):
        res = a.result(timeout=0)
        assert res.served_by == "default" and res.latency_s >= 0
        same_answer(res, b.result(timeout=0), q)


def test_priority_then_fifo_ordering(registry):
    sch = QueryScheduler(registry, max_batch=1)
    done_order = []
    for tag, prio in [("a0", 0), ("b1", 1), ("c0", 0), ("d2", 2), ("e1", 1)]:
        fut = sch.submit(Query(gid="road", source=0), priority=prio)
        fut.add_done_callback(lambda _f, t=tag: done_order.append(t))
    sch.drain()
    assert done_order == ["d2", "b1", "e1", "a0", "c0"]


def test_padded_slots_never_leak(registry):
    sch = QueryScheduler(registry, max_batch=8)
    srcs = [5, 17, 40]
    futs = [sch.submit(Query(gid="road", source=s)) for s in srcs]
    assert sch.step()
    stats = sch.stats()
    assert stats["n_done"] == 3 and stats["n_batches"] == 1
    assert stats["occupancy"] == pytest.approx(3 / 8)
    dg = registry.engine("road").g
    for s, fut in zip(srcs, futs):
        res = fut.result(timeout=0)
        d_ref, p_ref, _ = sssp(dg, s, device="cpu")
        np.testing.assert_array_equal(res.dist, d_ref.numpy())
        np.testing.assert_array_equal(res.parent, p_ref.numpy())


def test_cancelled_future_with_deadline_does_not_break_step(registry):
    sch = QueryScheduler(registry, max_batch=2)
    doomed = sch.submit(Query(gid="road", source=1), deadline_s=0.0)
    assert doomed.cancel()
    ok = sch.submit(Query(gid="road", source=2))
    time.sleep(0.01)
    sch.drain()
    assert ok.result(timeout=0).dist is not None


def test_validation(registry):
    for kw in (dict(admit_window=0), dict(max_batch=0),
               dict(max_pending=0)):
        with pytest.raises(ValueError):
            QueryScheduler(registry, **kw)


def test_deadline_expiry(registry):
    sch = QueryScheduler(registry, max_batch=2)
    doomed = sch.submit(Query(gid="road", source=1), deadline_s=0.0)
    alive = sch.submit(Query(gid="road", source=2), deadline_s=60.0)
    time.sleep(0.01)
    sch.drain()
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=0)
    assert alive.result(timeout=0).dist is not None
    assert sch.stats()["n_expired"] == 1


def test_ecc_batch_grouping(registry):
    """Companion slots are ecc-nearest to the head, not FIFO-next."""
    ecc = registry.engine("road").ecc_hint
    order = np.argsort(ecc)
    near_a, near_b, far = int(order[0]), int(order[1]), int(order[-1])
    assert ecc[far] - ecc[near_a] > ecc[near_b] - ecc[near_a]
    sch = QueryScheduler(registry, max_batch=2)
    f_near_a = sch.submit(Query(gid="road", source=near_a))
    f_far = sch.submit(Query(gid="road", source=far))
    f_near_b = sch.submit(Query(gid="road", source=near_b))
    assert sch.step()
    assert f_near_a.done() and f_near_b.done() and not f_far.done()
    sch.drain()
    assert f_far.done()


def test_fifo_companions_without_ecc_batching(registry):
    sch = QueryScheduler(registry, max_batch=2, ecc_batching=False)
    center = SIDE * (SIDE // 2) + SIDE // 2
    f1 = sch.submit(Query(gid="road", source=0))
    f2 = sch.submit(Query(gid="road", source=center))
    f3 = sch.submit(Query(gid="road", source=SIDE * SIDE - 1))
    assert sch.step()
    assert f1.done() and f2.done() and not f3.done()
    sch.drain()


@pytest.mark.parametrize("n_bad", [1, 3], ids=["one", "overflow-group"])
def test_engine_failure_fails_the_batch_not_the_scheduler(registry, n_bad):
    # more than max_batch same-key tickets take the ecc-grouping lookup
    # during selection; an unknown gid must fail its futures, not step()
    sch = QueryScheduler(registry, max_batch=2)
    bad = [sch.submit(Query(gid="unregistered", source=0))
           for _ in range(n_bad)]
    good = sch.submit(Query(gid="road", source=3))
    sch.drain()
    for f in bad:
        with pytest.raises(KeyError):
            f.result(timeout=0)
    assert good.result(timeout=0).dist is not None


def test_sharded_gid_fails_its_future_naming_item_10(gloo_one):
    """A sharded-tier gid's queries batch like any other and are served
    by its ShardedGraphEngine (one gloo rank): every answer bitwise the
    reference scheduler's, next to a single-tier gid's."""
    reg = GraphRegistry(capacity=2, shard_threshold_n=100,
                        shard_devices=["cpu"])
    rreg = RefRegistry(capacity=2, shard_threshold_n=100)
    for gid, args in (("big", ("road_grid", SIDE)),
                      ("small", ("kronecker", 6, 4))):
        rg, hg = graph(*args, seed=5 if gid == "big" else 2)
        reg.register(gid, hg)
        rreg.register(gid, rg)
    assert reg.tier("big") == "sharded"
    sch = QueryScheduler(reg, max_batch=2)
    rsch = RefScheduler(rreg, max_batch=2)
    qs = [dict(gid="big", source=0), dict(gid="small", source=1),
          dict(gid="big", source=5, kind="bounded", bound=2.0),
          dict(gid="big", source=9, kind="p2p", target=100)]
    futs = [sch.submit(Query(**q)) for q in qs]
    rfuts = [rsch.submit(RefQuery(**q)) for q in qs]
    sch.drain()
    rsch.drain()
    for q, a, b in zip(qs, futs, rfuts):
        same_answer(a.result(timeout=0), b.result(timeout=0), str(q))


def test_out_of_range_vertices_fail_loudly(registry):
    n = SIDE * SIDE
    sch = QueryScheduler(registry, max_batch=2)
    bad_src = sch.submit(Query(gid="road", source=n + 5))
    bad_tgt = sch.submit(Query(gid="road", source=0, kind="p2p", target=n))
    good = sch.submit(Query(gid="road", source=0))
    sch.drain()
    for f in (bad_src, bad_tgt):
        with pytest.raises(ValueError):
            f.result(timeout=0)
    assert good.result(timeout=0).dist is not None


def test_finalized_arrays_expose_only_settled_values(registry):
    sch = QueryScheduler(registry, max_batch=2)
    f_p2p = sch.submit(Query(gid="road", source=0, kind="p2p", target=30))
    f_k = sch.submit(Query(gid="road", source=0, kind="knear", k=5))
    sch.drain()
    r = f_p2p.result(timeout=0)
    finite = np.isfinite(r.dist)
    assert np.isfinite(r.distance) and np.all(r.dist[finite] <= r.distance)
    assert np.all(r.parent[~finite] == -1)
    assert int(np.isfinite(f_k.result(timeout=0).dist).sum()) == 5 + 1


def test_bounded_queue_rejects_at_submit_time(registry):
    sch = QueryScheduler(registry, max_batch=2, max_pending=2)
    f1 = sch.submit(Query(gid="road", source=0))
    f2 = sch.submit(Query(gid="road", source=1))
    with pytest.raises(QueueFull):
        sch.submit(Query(gid="road", source=2))
    assert sch.stats()["rejected"] == sch.n_rejected == 1
    sch.drain()
    assert f1.result(timeout=0).dist is not None
    assert f2.result(timeout=0).dist is not None
    f3 = sch.submit(Query(gid="road", source=2))
    sch.drain()
    assert f3.result(timeout=0).dist is not None


def test_measured_rounds_feed_back_into_batch_hint(registry):
    sch = QueryScheduler(registry, max_batch=2, feedback_gamma=0.5)
    eng = registry.engine("road")
    before = eng.batch_hint.copy()
    srcs = [5, 17]
    futs = [sch.submit(Query(gid="road", source=s)) for s in srcs]
    assert sch.step()
    for s, f in zip(srcs, futs):
        r = f.result(timeout=0).metrics["n_rounds"]
        assert eng.batch_hint[s] == pytest.approx(0.5 * before[s] + 0.5 * r)
    sch2 = QueryScheduler(registry, max_batch=2, feedback=False)
    after = eng.batch_hint.copy()
    sch2.submit(Query(gid="road", source=40))
    sch2.drain()
    np.testing.assert_array_equal(eng.batch_hint, after)


@pytest.mark.parametrize("kind", ["tree", "p2p"])
def test_background_worker_pipelines_batches(registry, kind):
    """The double-buffered worker: many small batches all resolve to
    their own source's answer; stop() joins the thread."""
    sch = QueryScheduler(registry, max_batch=2, ecc_batching=False)
    dg = registry.engine("road").g
    kw = {"kind": "p2p", "target": 100} if kind == "p2p" else {}
    sch.start()
    try:
        srcs = list(range(0, 24, 2))
        futs = [sch.submit(Query(gid="road", source=s, **kw)) for s in srcs]
        for s, fut in zip(srcs, futs):
            res = fut.result(timeout=120)
            assert res.latency_s >= 0
            d_ref, _, _ = sssp(dg, s, device="cpu")
            if kind == "tree":
                np.testing.assert_array_equal(res.dist, d_ref.numpy())
            else:
                assert res.distance == float(d_ref[100])
                assert res.path[0] == s and res.path[-1] == 100
    finally:
        sch.stop()
    st = sch.stats()
    assert st["n_done"] == 12 and st["pending"] == 0 and st["inflight"] == 0
    assert sch._worker is None


def test_stop_can_cancel_pending(registry):
    sch = QueryScheduler(registry, max_batch=2)
    fut = sch.submit(Query(gid="road", source=0))
    sch.stop(cancel_pending=True)
    assert fut.cancelled() and sch.outstanding() == 0


# -- metrics read-through on a fake clock (tests/test_obs_serving.py) ------

def _fake(clock, **kw):
    reg = GraphRegistry(capacity=2, device="cpu")
    reg.register("g", port("kronecker", 8, 4, seed=0))
    return QueryScheduler(reg, max_batch=4, ecc_batching=False,
                          clock=clock, **kw)


def test_deterministic_latency_histogram():
    clock = FakeClock()
    sch = _fake(clock)
    for i in range(4):
        sch.submit(Query(gid="g", source=i))
    clock.advance(2.0)
    assert sch.step()
    h = sch._h_latency
    assert h.count == 4 and h.sum == pytest.approx(8.0)
    assert h.percentile(0.50) == pytest.approx(1.75)
    assert h.percentile(0.99) == pytest.approx(1.0 + 1.5 * 0.99)
    entry = sch.metrics.snapshot()[
        'sssp_query_latency_seconds{scheduler="default"}']
    assert entry["count"] == 4 and entry["p99"] == pytest.approx(2.485)


def test_deadline_expiry_on_fake_clock():
    clock = FakeClock()
    sch = _fake(clock)
    doomed = sch.submit(Query(gid="g", source=0), deadline_s=1.0)
    alive = sch.submit(Query(gid="g", source=1), deadline_s=60.0)
    clock.advance(5.0)
    assert sch.step()
    assert isinstance(doomed.exception(), DeadlineExceeded)
    assert alive.result().dist is not None
    assert sch.n_expired == 1 and sch.n_done == 1
    snap = sch.metrics.snapshot()
    assert snap['sssp_scheduler_expired_total{scheduler="default"}'][
        "value"] == 1
    assert snap['sssp_scheduler_pending{scheduler="default"}']["value"] == 0
    assert snap['sssp_scheduler_inflight{scheduler="default"}']["value"] == 0


def test_submit_now_override():
    sch = _fake(FakeClock(start=50.0))
    fut = sch.submit(Query(gid="g", source=0), deadline_s=1.0, _now=10.0)
    assert sch.step() is False
    assert isinstance(fut.exception(), DeadlineExceeded)


def test_stats_dict_reads_through_metrics():
    sch = _fake(FakeClock())
    for i in range(6):
        sch.submit(Query(gid="g", source=i))
    sch.drain()
    st = sch.stats()
    assert st["n_batches"] == sch.n_batches == sch._c_batches.value == 2
    assert st["n_done"] == 6
    assert st["registry"]["builds"] == sch.registry.stats.builds == 1
    assert st["occupancy"] == pytest.approx(6 / 8)
    text = parse_prometheus(to_prometheus(sch.metrics.snapshot()))
    assert text['sssp_scheduler_queries_done_total{scheduler="default"}'] \
        == 6
