"""Port parity: the single-device tree solve (``repro_torch.core.sssp``).

Both packages run on byte-identical graphs (the reference's arrays carried
over with ``convert.from_reference``).  Each port backend must give
``dist``/``parent`` bitwise equal to the reference and the same logical
counters, and agree with Dijkstra.  Seed 3679 of the reference's
property test is a known reference fault (ROADMAP queue 3): the port
reproduces it bit for bit, and it fails against Dijkstra.
"""
import functools

import numpy as np
import pytest
import torch

import repro.data.generators as rgen
from repro.core.graph import build_csr as ref_build_csr
from repro.core.sssp import LOGICAL_METRIC_FIELDS as REF_LOGICAL
from repro.core.sssp import sssp as ref_sssp
from repro_torch import convert
from repro_torch.core.baselines import dijkstra_host
from repro_torch.core.config import ConfigError
from repro_torch.core.graph import default_geometry
from repro_torch.core.sssp import (LOGICAL_METRIC_FIELDS, metrics_dict,
                                   normalized_metrics, prepare_layout, sssp)
from test_torch_graph import ref_arrays
from release_xla import release_compiled  # noqa: F401

BLOCKED = dict(block_v=128, tile_e=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the solves here are thousands of tiny ops: threads only add overhead
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

DIJKSTRA_GRAPHS = [            # tests/test_sssp_core.py::test_matches_dijkstra
    ("kronecker", dict(scale=10, edge_factor=8, seed=1)),
    ("kronecker", dict(scale=12, edge_factor=4, seed=2)),
    ("uniform_random", dict(n=2000, m=16000, seed=3)),
    ("road_grid", dict(side=40, seed=4)),
]
SCALE = 8
BENCH_GRAPHS = {               # benchmarks/common.py::benchmark_graphs(8)
    "gr8_4": ("kronecker", dict(scale=SCALE, edge_factor=4, seed=1)),
    "gr8_8": ("kronecker", dict(scale=SCALE, edge_factor=8, seed=2)),
    "gr8_16": ("kronecker", dict(scale=SCALE, edge_factor=16, seed=3)),
    "gr8_32": ("kronecker", dict(scale=SCALE, edge_factor=32, seed=4)),
    "Road": ("road_grid", dict(side=16, seed=5)),
    "Urand": ("uniform_random", dict(n=256, m=16 * 256, seed=6)),
    "Web": ("kronecker", dict(scale=SCALE, edge_factor=30, seed=7)),
    "Twitter": ("kronecker", dict(scale=SCALE, edge_factor=22, seed=8)),
    "Kron": ("kronecker", dict(scale=SCALE, edge_factor=32, seed=9)),
}


def _np(out):
    dist, parent, metrics = out
    return (np.asarray(dist), np.asarray(parent),
            {f: int(getattr(metrics, f)) for f in REF_LOGICAL})


def _port(out):
    dist, parent, metrics = out
    return dist.numpy(), parent.numpy(), metrics_dict(metrics)


def assert_same(ref, port, what):
    np.testing.assert_array_equal(ref[0].view(np.int32),
                                  port[0].view(np.int32),
                                  err_msg=f"{what}: dist")
    np.testing.assert_array_equal(ref[1], port[1], err_msg=f"{what}: parent")
    bad = {f: (ref[2][f], port[2][f]) for f in LOGICAL_METRIC_FIELDS
           if ref[2][f] != port[2][f]}
    assert not bad, (what, bad)


def assert_dijkstra(hg, src, dist):
    dref, _ = dijkstra_host(hg, src)
    np.testing.assert_allclose(np.where(np.isfinite(dist), dist, -1.0),
                               np.where(np.isfinite(dref), dref, -1.0),
                               rtol=1e-4, atol=1e-5)


def _both(rg, src, ref_backend="segment_min", **ref_opts):
    """The reference solve and both port backends on the same graph."""
    ref = _np(ref_sssp(rg.to_device(), src, backend=ref_backend,
                       **ref_opts))
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    outs = {be: _port(sssp(hg, src, backend=be, device="cpu", **opts))
            for be, opts in (("segment_min", {}), ("blocked", BLOCKED))}
    return ref, outs, hg


@pytest.mark.parametrize("maker,kwargs", DIJKSTRA_GRAPHS,
                         ids=lambda x: str(x))
def test_matches_reference_and_dijkstra(maker, kwargs):
    rg = getattr(rgen, maker)(**kwargs)
    src = int(np.argmax(rg.deg))
    ref, outs, hg = _both(rg, src)
    for be, out in outs.items():
        assert_same(ref, out, f"{maker}{kwargs} {be}")
    assert_dijkstra(hg, src, outs["segment_min"][0])


@pytest.mark.parametrize("name", list(BENCH_GRAPHS))
def test_benchmark_graphs_match_reference(name):
    maker, kwargs = BENCH_GRAPHS[name]
    rg = getattr(rgen, maker)(**kwargs)
    src = int(np.argmax(rg.deg))
    # the reference's blocked path with its jnp twin (use_kernel=False)
    ref, outs, hg = _both(rg, src, "blocked_pallas", use_kernel=False,
                          **BLOCKED)
    for be, out in outs.items():
        assert_same(ref, out, f"{name} {be}")
    assert_dijkstra(hg, src, outs["blocked"][0])


@pytest.mark.parametrize("name", ["Road", "gr8_16"])
def test_card_geometry_matches_reference(name):
    """The one-bucket layout derived for the card, relaxed by the plain
    version, against the reference."""
    maker, kwargs = BENCH_GRAPHS[name]
    rg = getattr(rgen, maker)(**kwargs)
    src = int(np.argmax(rg.deg))
    ref = _np(ref_sssp(rg.to_device(), src, backend="segment_min"))
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    block_v, tile_e = default_geometry(hg.n, "cuda")
    out = sssp(hg, src, backend="blocked", device="cpu", block_v=block_v,
               tile_e=tile_e)
    assert_same(ref, _port(out), f"{name} one-bucket layout")


def _property_graph(seed):
    """tests/test_sssp_core.py::test_property_random_graphs_match_oracle's
    graph and source for one seed."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 150))
    m = int(rng.integers(n, 6 * n))
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    keep = u != v
    w = rng.random(keep.sum()) * float(rng.uniform(0.5, 10)) + 1e-3
    g = ref_build_csr(n, u[keep], v[keep], w)
    nz = np.where(g.deg > 0)[0]
    return g, int(nz[rng.integers(0, nz.size)])


@pytest.mark.parametrize("seed", [0, 42, 999, 5000, 8191])
def test_random_sweep_matches_reference(seed):
    rg, src = _property_graph(seed)
    ref, outs, hg = _both(rg, src)
    for be, out in outs.items():
        assert_same(ref, out, f"seed {seed} {be}")
    assert_dijkstra(hg, src, outs["segment_min"][0])


@functools.lru_cache(maxsize=1)
def _seed_3679():
    rg, src = _property_graph(3679)
    return _both(rg, src) + (src,)


def test_known_reference_fault_is_reproduced_bitwise():
    ref, outs, _, _ = _seed_3679()
    for be, out in outs.items():
        assert_same(ref, out, f"seed 3679 {be}")


@pytest.mark.xfail(strict=True, reason="known reference fault (ROADMAP "
                   "queue 3 item 1): a candidate equal to ub is dropped")
def test_known_reference_fault_against_dijkstra():
    _, outs, hg, src = _seed_3679()
    assert_dijkstra(hg, src, outs["segment_min"][0])


def test_blocked_interpret_mode_kernel_on_one_graph():
    """The reference's Pallas kernel itself (interpret mode), not its
    jnp twin, on one small graph."""
    rg = rgen.kronecker(7, 4, seed=3)
    src = int(np.argmax(rg.deg))
    ref = ref_sssp(rg.to_device(), src, backend="blocked_pallas",
                   interpret=True, **BLOCKED)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    out = sssp(hg, src, backend="blocked", device="cpu", **BLOCKED)
    assert_same(_np(ref), _port(out), "interpret-mode kernel")
    # the physical tile count follows the identical layout
    assert float(ref[2].n_tiles_scanned) == out[2].n_tiles_scanned.item()


def test_prepared_layout_and_metrics():
    hg = convert.from_reference(ref_arrays(rgen.road_grid(12, seed=2)),
                                "cpu")
    dg = hg.to_device("cpu")
    layout = prepare_layout(dg, "blocked", device="cpu", **BLOCKED)
    dist, parent, m = sssp(dg, 5, backend="blocked", layout=layout,
                           device="cpu")
    md = metrics_dict(m)
    assert md["n_invocations"] > 0 and md["n_host_syncs"] >= md["n_steps"]
    assert set(LOGICAL_METRIC_FIELDS) <= set(md)
    nm = normalized_metrics(dg.deg, dist, m)
    assert nm["reachable"] == hg.n and nm["n_rounds"] == md["n_rounds"]
    with pytest.raises(ValueError, match="either layout"):
        sssp(dg, 5, backend="blocked", layout=layout, device="cpu",
             **BLOCKED)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(config={}), ConfigError, "expected EngineConfig"),
    (dict(fused_rounds=4), ValueError, "fused"),
    (dict(policy="adaptive"), None, None),
    (dict(trace=True), None, None),
    (dict(bogus_opt=1), TypeError, "bogus_opt"),
    (dict(goal_params=[1]), TypeError, "goal_params"),
    (dict(goal="p2p", goal_param=3, p2p_mode="bidirectional"), ValueError,
     "needs a landmark set")])
def test_later_slices_raise(kw, exc, match):
    """Each option behaves as the reference's: a dict is not a config
    (``ConfigError``), fused rounds on the default ``segment_min`` backend
    raise ``ConfigError`` (a ``ValueError``), the adaptive policy and a
    traced solve run (bitwise the reference's), an unknown keyword raises
    ``TypeError`` naming it, and the bidirectional p2p mode without
    landmarks raises ``ConfigError``."""
    rg = rgen.road_grid(4, seed=1)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    if exc is None:
        from repro.core.config import EngineConfig
        ref = _np(ref_sssp(rg.to_device(), 0,
                           config=EngineConfig(**kw))[:3])
        assert_same(ref, _port(sssp(hg, 0, device="cpu", **kw)[:3]),
                    str(kw))
        return
    with pytest.raises(exc, match=match):
        sssp(hg, 0, device="cpu", **kw)


def test_unknown_options_are_refused_not_dropped():
    """The reproduction of the fault that dropped options silently
    (kronecker(10, 8), seed 1, source 0): a dict passed as ``config=``
    raises the reference's ``ConfigError``, unknown keywords raise with
    the reference's ``TypeError``, and ``goal_param`` is honoured."""
    from repro.core.config import EngineConfig
    rg = rgen.kronecker(10, 8, seed=1)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    with pytest.raises(ConfigError, match="expected EngineConfig"):
        sssp(hg, 0, device="cpu", config={"alpha": 1.5, "beta": 0.5},
             goal_param=3)
    with pytest.raises(TypeError, match="unknown engine options"):
        ref_sssp(rg.to_device(), 0, bogus_opt=1)
    # use_kernel is the reference's Pallas switch: the port has none
    for bad in (dict(bogus_opt=1), dict(use_kernel=False)):
        with pytest.raises(TypeError, match="unknown engine options"):
            sssp(hg, 0, device="cpu", **bad)
        with pytest.raises(TypeError, match="unknown engine options"):
            prepare_layout(hg, "blocked", device="cpu", **bad)
    # the options that change the schedule are honoured as the
    # reference's are
    ref = _np(ref_sssp(rg.to_device(), 0,
                       config=EngineConfig(alpha=1.5, beta=0.5)))
    assert_same(ref, _port(sssp(hg, 0, device="cpu", alpha=1.5, beta=0.5)),
                "alpha=1.5 beta=0.5")
    tree = _port(sssp(hg, 0, device="cpu"))
    assert ref[2]["n_rounds"] != tree[2]["n_rounds"]
    p2p = _port(sssp(hg, 0, device="cpu", goal="p2p", goal_param=3))
    assert p2p[2]["n_steps"] <= tree[2]["n_steps"]
    assert p2p[0][3] == tree[0][3]


def test_source_out_of_range_raises():
    hg = convert.from_reference(ref_arrays(rgen.road_grid(4, seed=1)),
                                "cpu")
    with pytest.raises(ValueError, match="out of range"):
        sssp(hg, 16, device="cpu")
