"""Port parity: the workload generators (``repro_torch.data.weights``,
``traffic``, ``sampler``) against the JAX package's, and the CSR that
``chip_smoke.py`` phase 4e-d builds on the card for the sampler.

Everything here is numpy on the host, so every comparison is exact: the
variant graphs field for field, the traffic item for item (query,
priority, deadline, arrival), the sampled blocks and the flat subgraph
array for array, dtypes included.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.data.generators as rgen
from repro.data import sampler as rsampler, traffic as rtraffic, \
    weights as rweights
from repro.data.synthetic import gnn_node_classification
from repro_torch import convert
from repro_torch.data import sampler, traffic, weights
from test_torch_graph import ref_arrays

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import gnn_phase  # noqa: E402

POWERS = [1, 2, 4, 10]            # benchmarks/common.py::variant_graphs
PIVOTS = [0.1, 0.5, 0.9]


def same_host_graph(port, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f.name
        else:
            assert a == b and type(a) is type(b), f.name


def _base():
    rg = rgen.kronecker(9, 8, seed=21)
    return rg, convert.from_reference(ref_arrays(rg), "cpu")


@pytest.mark.parametrize("kw", [dict(power=p) for p in POWERS]
                         + [dict(pivot=p) for p in PIVOTS],
                         ids=lambda kw: str(kw))
def test_make_variant_is_the_references_bitwise(kw):
    rg, hg = _base()
    same_host_graph(weights.make_variant(hg, **kw),
                    rweights.make_variant(rg, **kw))


def test_weight_maps_are_the_references_bitwise():
    w = np.random.default_rng(0).random(10_000)
    w[:3] = [0.0, 0.5, 1.0]
    for p in POWERS:
        assert np.array_equal(weights.discretize(w, p),
                              rweights.discretize(w, p))
    for pv in PIVOTS:
        assert np.array_equal(weights.converge(w, pv),
                              rweights.converge(w, pv))


@pytest.mark.parametrize("kw", [{}, dict(power=2, pivot=0.5)])
def test_make_variant_needs_exactly_one_of_power_and_pivot(kw):
    rg, hg = _base()
    with pytest.raises(ValueError, match="exactly one of power/pivot"):
        rweights.make_variant(rg, **kw)
    with pytest.raises(ValueError, match="exactly one of power/pivot"):
        weights.make_variant(hg, **kw)


def _traffic_graphs():
    ref = {"social": rgen.kronecker(8, 8, seed=2),
           "road": rgen.road_grid(16, seed=5),
           "urand": rgen.uniform_random(300, 900, seed=3)}
    port = {k: convert.from_reference(ref_arrays(g), "cpu")
            for k, g in ref.items()}
    return ref, port


TRAFFIC_CASES = {
    "default": dict(),
    "seed 7, 100 queries": dict(seed=7, n_queries=100),
    "trees only": dict(mix=(("tree", 1.0),)),
    "p2p and knear": dict(mix=(("p2p", 0.3), ("knear", 0.7)), zipf_a=1.5),
    "bounds and k": dict(mix=(("bounded", 1.0), ("knear", 1.0)),
                         bound_w_scale=(0.5, 1.5), k_range=(1, 8)),
    "paced": dict(rate_qps=50.0),
    "deadlines": dict(deadline_s=0.25, priority_levels=5),
    "paced with deadlines": dict(rate_qps=7.5, deadline_s=1.0),
    "empty": dict(n_queries=0),
}


@pytest.mark.parametrize("case", list(TRAFFIC_CASES))
def test_make_traffic_is_the_references_item_for_item(case):
    kw = dict(TRAFFIC_CASES[case])
    n = kw.pop("n_queries", 64)
    ref_graphs, port_graphs = _traffic_graphs()
    want = rtraffic.make_traffic(ref_graphs, n, **kw)
    got = traffic.make_traffic(port_graphs, n, **kw)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert dataclasses.asdict(a.query) == dataclasses.asdict(b.query)
        assert (a.priority, a.deadline_s, a.arrival_s) == \
            (b.priority, b.deadline_s, b.arrival_s)
        assert type(a.query.source) is int
    if "rate_qps" in kw:
        arrivals = [it.arrival_s for it in got]
        assert arrivals == sorted(arrivals) and arrivals[0] > 0
        # pacing draws from a derived generator: the queries are the
        # unpaced stream's
        plain = traffic.make_traffic(port_graphs, n, **{
            k: v for k, v in kw.items() if k != "rate_qps"})
        assert [it.query for it in plain] == [it.query for it in got]


@pytest.mark.parametrize("kw,match", [
    (dict(n_queries=-1), "n_queries must be >= 0"),
    (dict(rate_qps=0.0), "rate_qps must be > 0"),
    (dict(rate_qps=-2.0), "rate_qps must be > 0")])
def test_make_traffic_refuses_what_the_reference_refuses(kw, match):
    n = kw.pop("n_queries", 8)
    ref_graphs, port_graphs = _traffic_graphs()
    with pytest.raises(ValueError, match=match):
        rtraffic.make_traffic(ref_graphs, n, **kw)
    with pytest.raises(ValueError, match=match):
        traffic.make_traffic(port_graphs, n, **kw)


def test_zipf_ranks_and_mix_are_the_references():
    assert traffic.DEFAULT_MIX == rtraffic.DEFAULT_MIX
    for a in (0.8, 1.1, 2.0):
        got = traffic.zipf_ranks(np.random.default_rng(3), 17, 500, a)
        want = rtraffic.zipf_ranks(np.random.default_rng(3), 17, 500, a)
        assert np.array_equal(got, want)
    assert np.bincount(got)[0] == np.bincount(got).max()


def _csr(n=400, e=1600, seed=0):
    g = gnn_node_classification(n, e, 4, 3, seed=seed)
    return gnn_phase.csr_by_receiver(g["senders"], g["receivers"], n, "cpu")


@pytest.mark.parametrize("n,e,seed", [(400, 1600, 0), (50, 30, 1),
                                      (1000, 20000, 2)])
def test_csr_by_receiver_is_a_stable_argsort(n, e, seed):
    g = gnn_node_classification(n, e, 4, 3, seed=seed)
    row_ptr, col = gnn_phase.csr_by_receiver(g["senders"], g["receivers"], n,
                                             "cpu")
    order = np.argsort(g["receivers"], kind="stable")
    want_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(g["receivers"], minlength=n), out=want_ptr[1:])
    assert row_ptr.dtype == np.int64 and col.dtype == np.int32
    assert np.array_equal(row_ptr, want_ptr)
    assert np.array_equal(col, g["senders"][order])


def _same_arrays(a, b, what):
    assert a.dtype == b.dtype, what
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("fanouts,n_seeds", [((15, 10), 32), ((5,), 8),
                                             ((3, 2, 2), 20)])
def test_neighbor_sampler_is_the_references_bitwise(fanouts, n_seeds):
    row_ptr, col = _csr()
    seeds = np.random.default_rng(1).choice(400, n_seeds, replace=False)
    ps, rs = (sampler.NeighborSampler(row_ptr, col, fanouts, seed=4),
              rsampler.NeighborSampler(row_ptr, col, fanouts, seed=4))
    for _ in range(2):            # the generator advances the same way
        got, want = ps.sample(seeds), rs.sample(seeds)
        assert len(got.blocks) == len(want.blocks) == len(fanouts)
        for i, (a, b) in enumerate(zip(got.blocks, want.blocks)):
            for f in sampler.SampledBlock._fields:
                _same_arrays(getattr(a, f), getattr(b, f), f"block {i} {f}")
        _same_arrays(got.input_nodes, want.input_nodes, "input_nodes")
        assert got.seeds is seeds
    assert got.blocks[0].senders.dtype == np.int32
    assert got.blocks[0].src_nodes.dtype == np.int64


@pytest.mark.parametrize("pads", [(5664, 5760), (100, 300), (40, 40)],
                         ids=["fits", "truncates edges", "truncates both"])
def test_flat_subgraph_is_the_references_bitwise(pads):
    row_ptr, col = _csr()
    seeds = np.random.default_rng(2).choice(400, 32, replace=False)
    batch = sampler.NeighborSampler(row_ptr, col, (15, 10), seed=0) \
        .sample(seeds)
    got = sampler.flat_subgraph(batch, *pads)
    want = rsampler.flat_subgraph(batch, *pads)
    for name, a, b in zip(("senders", "receivers", "edge_mask", "node_ids",
                           "node_mask"), got, want):
        _same_arrays(a, b, name)
    nodes, edges = int(got[4].sum()), int(got[2].sum())
    assert nodes == min(batch.input_nodes.size, pads[0])
    assert edges <= pads[1]
    if pads == (40, 40):
        # truncated: the kept edges may name nodes past the node pad, as
        # the reference's do (it drops silently)
        assert edges == 40 and nodes == 40
