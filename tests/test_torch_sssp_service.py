"""Port parity: the single-graph endpoint (``repro_torch.serve.sssp_service``).

Mirrors ``tests/test_sssp_service.py``, the service parts of
``tests/test_obs_serving.py`` and ``test_api.py``'s config case on the
CPU: requests batch FIFO and match the engine, bitwise the reference
service's answers to the same requests; a failed request does not wedge
the service; one metrics snapshot covers the registry, the scheduler
and, routed, the router, through the Prometheus text and a JSONL line;
``apply_delta`` patches the served graph.
"""
import json

import numpy as np
import pytest
import torch

from repro.serve.sssp_service import SsspRequest as RefRequest
from repro.serve.sssp_service import SsspService as RefService
from repro_torch.api import EngineConfig
from repro_torch.core.baselines import dijkstra_host
from repro_torch.core.sssp import sssp
from repro_torch.delta import EdgeDelta
from repro_torch.obs import parse_prometheus
from repro_torch.serve.sssp_service import SsspRequest, SsspService
from torch_serve_common import CPU, LOGICAL_KEYS, cpus, graph, port
from release_xla import release_compiled  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeClock:
    def __init__(self, start: float = 100.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


REQUESTS = [dict(source=3), dict(source=40, kind="p2p", target=200),
            dict(source=9), dict(source=100, kind="knear", k=7),
            dict(source=17, kind="bounded", bound=1.5)]


@pytest.mark.parametrize("routed", [False, True], ids=["sync", "routed"])
def test_service_answers_match_the_reference(routed):
    """Mixed requests through both packages' services: each request's
    fields bitwise the reference's; full trees also match the engine and
    Dijkstra."""
    rg, hg = graph("kronecker", 8, 6, seed=2)
    ref = RefService(rg, max_batch=2)
    svc = (SsspService(hg, max_batch=2, devices=cpus(2)) if routed
           else SsspService(hg, max_batch=2, device="cpu"))
    want = [ref.submit(RefRequest(rid=i, **r)) for i, r in
            enumerate(REQUESTS)]
    got = [svc.submit(SsspRequest(rid=i, **r)) for i, r in
           enumerate(REQUESTS)]
    ref.run()
    assert svc.run() >= 3 and not svc.queue
    for r, a, b in zip(REQUESTS, got, want):
        assert a.done and a.error is None, r
        np.testing.assert_array_equal(a.dist.view(np.int32),
                                      b.dist.view(np.int32), err_msg=str(r))
        np.testing.assert_array_equal(a.parent, b.parent)
        assert {k: a.metrics[k] for k in LOGICAL_KEYS} \
            == {k: b.metrics[k] for k in LOGICAL_KEYS}, r
        assert (a.distance, a.path, a.nearest) \
            == (b.distance, b.path, b.nearest), r
    for a in got:
        if a.kind == "tree":
            d, p, _ = sssp(hg, a.source, device="cpu")
            np.testing.assert_array_equal(a.dist, d.numpy())
            np.testing.assert_array_equal(a.parent, p.numpy())
            dref, _ = dijkstra_host(hg, a.source)
            np.testing.assert_allclose(
                np.where(np.isfinite(a.dist), a.dist, -1.0),
                np.where(np.isfinite(dref), dref, -1.0), rtol=1e-4,
                atol=1e-5)
    assert (svc.router is not None) == routed
    assert (svc.g is None) == routed


def test_service_batches_fifo_and_partial_batches():
    hg = port("kronecker", 8, 6, seed=1)
    svc = SsspService(hg, max_batch=3, device="cpu")
    srcs = np.flatnonzero(hg.deg > 0)[:7]
    reqs = [svc.submit(SsspRequest(rid=i, source=int(s)))
            for i, s in enumerate(srcs)]
    assert svc.run() == 3                 # ceil(7 / 3) batches
    assert all(r.done for r in reqs) and svc.n_batches == 3
    assert reqs[0].metrics["nFrontier"] >= 0
    one = SsspService(hg, max_batch=4, backend="blocked", block_v=64,
                      tile_e=64, device="cpu")
    req = one.submit(SsspRequest(rid=0, source=int(np.argmax(hg.deg))))
    assert one.step() and not one.step()  # 1 request in a 4-slot batch
    d, p, _ = sssp(hg, req.source, device="cpu")
    np.testing.assert_array_equal(req.dist, d.numpy())
    np.testing.assert_array_equal(req.parent, p.numpy())
    assert one.g.device == CPU


def test_service_rejects_bad_graph_and_survives_bad_requests():
    with pytest.raises(TypeError):
        SsspService(object())
    hg = port("kronecker", 8, 6, seed=2)
    svc = SsspService(hg, max_batch=2, device="cpu")
    bad = svc.submit(SsspRequest(rid=0, source=hg.n + 5))
    good = svc.submit(SsspRequest(rid=1, source=0))
    svc.run()
    assert isinstance(bad.error, ValueError) and not bad.done
    assert good.done and good.error is None
    later = svc.submit(SsspRequest(rid=2, source=1))
    svc.run()
    assert later.done


def test_service_accepts_engine_config():
    """``config=`` is the one option surface; pinned devices route the
    service over them."""
    hg = port("road_grid", 12, seed=2)
    svc = SsspService(hg, config=EngineConfig(max_batch=4,
                                              devices=("cpu",)))
    assert svc.router is not None and svc.router.n_devices == 1
    reqs = [svc.submit(SsspRequest(rid=i, source=s))
            for i, s in enumerate((0, 5, 9))]
    svc.run()
    np.testing.assert_array_equal(reqs[1].dist,
                                  sssp(hg, 5, device="cpu")[0].numpy())
    from repro_torch.core.config import ConfigError
    with pytest.raises(ConfigError):
        SsspService(hg, config=EngineConfig(), max_batch=2)


def test_service_apply_delta_serves_the_patched_graph():
    hg = port("road_grid", 10, seed=5)
    svc = SsspService(hg, max_batch=2, device="cpu")
    u, v = int(hg.src[0]), int(hg.dst[0])
    report = svc.apply_delta(EdgeDelta(remove=[(u, v)],
                                       add=[(0, hg.n - 1, 0.5)]))
    assert report["engines_patched"] == 1 and svc.n == hg.n
    req = svc.submit(SsspRequest(rid=0, source=0))
    svc.run()
    d, p, _ = sssp(report["host"], 0, device="cpu")
    np.testing.assert_array_equal(req.dist, d.numpy())
    np.testing.assert_array_equal(req.parent, p.numpy())
    assert svc.g is svc.registry.engine("default").g


# -- one metrics snapshot (tests/test_obs_serving.py) -----------------------

def test_service_single_snapshot_covers_all_layers():
    clock = FakeClock()
    svc = SsspService(port("kronecker", 8, 4, seed=0), max_batch=4,
                      clock=clock, device="cpu")
    for i in range(8):
        svc.submit(SsspRequest(rid=i, source=i))
        clock.advance(0.125)
    svc.run()
    snap = svc.metrics_snapshot()
    bases = {name.split("{", 1)[0] for name in snap}
    assert {"sssp_registry_hits_total", "sssp_registry_builds_total",
            "sssp_scheduler_batches_total",
            "sssp_scheduler_queries_done_total",
            "sssp_query_latency_seconds"} <= bases
    done = 'sssp_scheduler_queries_done_total{scheduler="default"}'
    assert snap[done]["value"] == 8
    lat = snap['sssp_query_latency_seconds{scheduler="default"}']
    assert lat["count"] == 8 and lat["p50"] <= lat["p99"]
    parsed = parse_prometheus(svc.metrics_exposition())
    assert parsed[done] == 8
    assert parsed['sssp_query_latency_seconds_bucket'
                  '{le="+Inf",scheduler="default"}'] == 8


def test_service_routed_snapshot_includes_router():
    svc = SsspService(port("kronecker", 8, 4, seed=0), max_batch=4,
                      devices=cpus(1))
    for i in range(4):
        svc.submit(SsspRequest(rid=i, source=i))
    svc.run()
    snap = svc.metrics_snapshot()
    assert snap["sssp_router_routed_total"]["value"] == 4
    assert svc.router.n_routed == 4 == svc.router.stats()["n_routed"]


def test_service_jsonl_dump(tmp_path):
    svc = SsspService(port("kronecker", 8, 4, seed=0), max_batch=2,
                      device="cpu")
    svc.submit(SsspRequest(rid=0, source=0))
    svc.run()
    path = tmp_path / "serve_metrics.jsonl"
    snap = svc.dump_metrics_jsonl(path, run="unit")
    rec = json.loads(path.read_text().strip())
    assert rec["run"] == "unit"
    assert rec["metrics"] == json.loads(json.dumps(snap))
    done = 'sssp_scheduler_queries_done_total{scheduler="default"}'
    assert rec["metrics"][done]["value"] == 1
