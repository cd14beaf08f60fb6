"""The reference against a plain Dijkstra, the comparison against the
port and against the bfloat16 control (which has to fail), on the CPU."""
import heapq

import numpy as np
import pytest
import torch

from bench.graphs import csr, rmat, urand
from bench.reference import judge, sssp
from repro_torch import DeviceGraph, EngineConfig, SolveSpec, Solver

KRON = {"scale": 9, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
        "weights": "uniform_0_1", "structure_seed": 1}
URAND = {"scale": 9, "degree": 4, "weights": "uniform_0_1",
         "structure_seed": 1}


def _graph(mod, cfg, seed):
    return mod.generate(cfg, torch.Generator().manual_seed(seed), "cpu")


def dijkstra(n, eu, ev, ew, source):
    """A plain binary-heap Dijkstra in float64 over the undirected edges."""
    adj = [[] for _ in range(n)]
    for a, b, w in zip(eu.tolist(), ev.tolist(), ew.tolist()):
        adj[a].append((b, w))
        adj[b].append((a, w))
    dist = [float("inf")] * n
    dist[source] = 0.0
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for v, w in adj[u]:
            if d + w < dist[v]:
                dist[v] = d + w
                heapq.heappush(heap, (d + w, v))
    return np.array(dist)


@pytest.mark.parametrize("mod,cfg", [(rmat, KRON), (urand, URAND)],
                         ids=["rmat", "urand"])
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_is_dijkstra(mod, cfg, seed):
    el = _graph(mod, cfg, seed)
    for source in (0, 17, int(torch.bincount(el.eu).argmax())):
        ref = sssp.distances(el.n, el.eu, el.ev, el.ew, source, chunk=1000)
        want = dijkstra(el.n, el.eu, el.ev, el.ew.double(), source)
        got = ref.numpy()
        assert np.array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got[np.isfinite(want)],
                                   want[np.isfinite(want)], rtol=1e-12)


@pytest.fixture(scope="module")
def kron():
    el = _graph(rmat, KRON, 4)
    graph = DeviceGraph(*csr.build(el.n, el.eu, el.ev, el.ew))
    solver = Solver.open(graph, EngineConfig(backend="blocked",
                                             tier="single"), device="cpu")
    return el, solver


def test_port_passes(kron):
    el, solver = kron
    sources = (0, 5, 77, 300)
    res = solver.solve(SolveSpec.tree(sources))
    for i, s in enumerate(sources):
        ref = sssp.distances(el.n, el.eu, el.ev, el.ew, s)
        got = judge.judge(res.dist[i], res.parent[i], ref, s, el.eu, el.ev,
                          el.ew)
        assert judge.passes(got), got
        assert got["tree_gap"] == 0.0


@pytest.mark.parametrize("source", [0, 77])
def test_control_fails(kron, source):
    """The bfloat16 control, put in the program's place, fails both
    numbers by far."""
    el, _ = kron
    ref = sssp.distances(el.n, el.eu, el.ev, el.ew, source)
    d, p = sssp.control_tree(el.n, el.eu, el.ev, el.ew, source)
    got = judge.judge(d, p, ref, source, el.eu, el.ev, el.ew)
    assert not judge.passes(got)
    for k, limit in judge.LIMITS.items():
        assert got[k] > 10 * limit, (k, got)


def _solved(kron, source=5):
    el, solver = kron
    res = solver.solve(SolveSpec.tree(source))
    ref = sssp.distances(el.n, el.eu, el.ev, el.ew, source)
    return el, res.dist.clone(), res.parent.clone(), ref, source


def test_judge_finds_an_altered_distance(kron):
    el, d, p, ref, s = _solved(kron)
    v = int(torch.where(torch.isfinite(d), d, 0).argmax())
    d[v] = d[v] * (1 + 1e-3)
    got = judge.judge(d, p, ref, s, el.eu, el.ev, el.ew)
    assert got["dist_gap"] > judge.LIMITS["dist_gap"]
    assert got["tree_gap"] > judge.LIMITS["tree_gap"]


def test_judge_finds_a_wrong_parent(kron):
    el, d, p, ref, s = _solved(kron)
    v = int(torch.where(torch.isfinite(d), d, 0).argmax())
    p[v] = (int(p[v]) + 1) % el.n
    got = judge.judge(d, p, ref, s, el.eu, el.ev, el.ew)
    assert got["dist_gap"] <= judge.LIMITS["dist_gap"]
    assert got["tree_gap"] > judge.LIMITS["tree_gap"]


def test_judge_finds_unreached_vertices(kron):
    el, d, p, ref, s = _solved(kron)
    v = int(torch.where(torch.isfinite(d), d, 0).argmax())
    d[v] = float("inf")
    got = judge.judge(d, p, ref, s, el.eu, el.ev, el.ew)
    assert got["dist_gap"] == float("inf")
    assert not judge.passes(got)
