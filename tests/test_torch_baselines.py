"""Port parity: the SSSP baselines (``repro_torch.core.baselines``).

``bellman_ford`` and ``delta_stepping`` run on byte-identical graphs in
both packages (the reference's arrays carried over with
``convert.from_reference``); ``dist``, ``parent`` and every logical
counter must be bitwise the reference's, at every ``delta`` (among them
ones that f32 cannot hold exactly) and when ``max_iters`` truncates the
run.  Bellman-Ford's ``dist`` is the least fixed point of
``d[v] = min fl(d[u] + w)``, so it must also equal the port's own EIC
tree solve bit for bit, which is what ``chip_smoke.py`` phase 4e checks
on the card.
"""
import functools

import numpy as np
import pytest
import torch

import repro.data.generators as rgen
from repro.core.baselines import bellman_ford as ref_bellman_ford
from repro.core.baselines import delta_stepping as ref_delta_stepping
from repro.core.graph import build_csr as ref_build_csr
from repro.data.weights import make_variant as ref_make_variant
from repro_torch import convert
from repro_torch.core.baselines import bellman_ford, delta_stepping
from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict, sssp
from test_torch_graph import ref_arrays
from test_torch_sssp import _np, _port, assert_same
from release_xla import release_compiled  # noqa: F401


def _two_components():
    """Two components: the source's reaches 4 vertices, 4 stay at inf."""
    u = np.array([0, 1, 2, 0, 4, 5, 6])
    v = np.array([1, 2, 3, 3, 5, 6, 7])
    w = np.array([0.5, 0.25, 0.125, 1.0, 0.3, 0.7, 0.2])
    return ref_build_csr(8, u, v, w)


GRAPHS = {
    "kronecker(10,8)": lambda: rgen.kronecker(10, 8, seed=1),
    "road_grid(24)": lambda: rgen.road_grid(24, seed=4),
    "uniform_random": lambda: rgen.uniform_random(600, 3000, seed=3),
    "kronecker(9,8) pow1": lambda: ref_make_variant(
        rgen.kronecker(9, 8, seed=2), power=1),
    "two components": _two_components,
}
# absolute deltas, then the benchmark's multiples of max_w
# (benchmarks/run.py: 0.1, 0.5 and 1.0 x max_w)
DELTAS = [("abs", 0.1), ("abs", 0.3), ("abs", 1.0),
          ("max_w", 0.1), ("max_w", 0.5), ("max_w", 1.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _graph(name):
    """``(reference HostGraph, its DeviceGraph, the port's DeviceGraph on
    the CPU, source)``; the source is the max-degree vertex (vertex 0 of
    the two-component graph)."""
    rg = GRAPHS[name]()
    src = 0 if name == "two components" else int(np.argmax(rg.deg))
    dg = convert.from_reference(ref_arrays(rg), "cpu").to_device("cpu")
    return rg, rg.to_device(), dg, src


def _delta(rg, kind, x):
    return x if kind == "abs" else x * float(rg.max_w)


def _check_syncs(out, iterations: int):
    """One read per iteration that ran, and one that ended the loop."""
    assert metrics_dict(out[2])["n_host_syncs"] == iterations + 1


@pytest.mark.parametrize("name", list(GRAPHS))
def test_bellman_ford_matches_reference(name):
    rg, rdg, dg, src = _graph(name)
    ref = _np(ref_bellman_ford(rdg, src))
    out = bellman_ford(dg, src)
    assert_same(ref, _port(out), f"{name} bellman_ford")
    _check_syncs(out, ref[2]["n_rounds"])
    if name == "two components":
        assert np.isinf(out[0].numpy()[4:]).all()
        assert (out[1].numpy()[4:] == -1).all()


@pytest.mark.parametrize("kind,x", DELTAS, ids=lambda v: str(v))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_delta_stepping_matches_reference(name, kind, x):
    rg, rdg, dg, src = _graph(name)
    delta = _delta(rg, kind, x)
    ref_out = ref_delta_stepping(rdg, src, delta)
    out = delta_stepping(dg, src, delta)
    assert_same(_np(ref_out), _port(out), f"{name} delta={delta!r}")
    # one read per iteration (each light and each heavy pass relaxes
    # once) and the final read that sees the done flag
    _check_syncs(out, metrics_dict(out[2])["n_rounds"])


def test_delta_not_exact_in_f32_is_rounded_first():
    """0.1 x max_w of road_grid(24) is no float32: both packages round it
    to f32 before the first comparison, so the light set and every bucket
    edge are the reference's."""
    rg, rdg, dg, src = _graph("road_grid(24)")
    delta = 0.1 * float(rg.max_w)
    assert float(np.float32(delta)) != delta
    ref = _np(ref_delta_stepping(rdg, src, delta))
    assert_same(ref, _port(delta_stepping(dg, src, delta)), "road 0.1 max_w")
    assert_same(ref, _port(delta_stepping(dg, src, np.float32(delta))),
                "road f32(0.1 max_w)")


@pytest.mark.parametrize("name", ["kronecker(10,8)", "road_grid(24)"])
@pytest.mark.parametrize("solver", ["bellman_ford", "delta_stepping"])
def test_truncated_run_matches_reference(solver, name):
    rg, rdg, dg, src = _graph(name)
    if solver == "bellman_ford":
        ref = _np(ref_bellman_ford(rdg, src, max_iters=3))
        out = bellman_ford(dg, src, max_iters=3)
    else:
        delta = 0.5 * float(rg.max_w)
        ref = _np(ref_delta_stepping(rdg, src, delta, max_iters=3))
        out = delta_stepping(dg, src, delta, max_iters=3)
    assert_same(ref, _port(out), f"{name} {solver} max_iters=3")
    # three iterations, each with its own read, and no read after them
    assert metrics_dict(out[2])["n_host_syncs"] == 3
    assert np.isfinite(out[0].numpy()).sum() < rg.n


@pytest.mark.parametrize("name", list(GRAPHS))
def test_bellman_ford_dist_is_the_tree_solve_dist(name):
    _, _, dg, src = _graph(name)
    bf = bellman_ford(dg, src)[0]
    for backend in ("segment_min", "blocked"):
        tree = sssp(dg, src, backend=backend, device="cpu")[0]
        assert torch.equal(bf.view(torch.int32), tree.view(torch.int32)), \
            (name, backend)


@pytest.mark.parametrize("name", ["road_grid(24)", "kronecker(9,8) pow1"])
def test_delta_stepping_dist_is_bellman_ford_dist(name):
    rg, _, dg, src = _graph(name)
    bf = bellman_ford(dg, src)[0]
    for x in (0.1, 1.0):
        ds = delta_stepping(dg, src, x * float(rg.max_w))[0]
        assert torch.equal(bf.view(torch.int32), ds.view(torch.int32))


def test_baselines_count_like_the_engine():
    """The physical counters stay zero but for the host reads, and the
    logical ones are int32 like the engine's."""
    _, _, dg, src = _graph("kronecker(10,8)")
    for out in (bellman_ford(dg, src), delta_stepping(dg, src, 0.5)):
        m = out[2]
        for f in LOGICAL_METRIC_FIELDS:
            assert getattr(m, f).dtype == torch.int32
        md = metrics_dict(m)
        assert md["n_tiles_scanned"] == md["n_invocations"] == 0
        assert md["n_host_syncs"] > 0


def test_delta_stepping_livelock_is_reproduced_bitwise():
    """Reference fault 6 (ROADMAP queue 3): on road_grid(64, seed=5) at
    delta = max_w the reference's loop never ends.  A vertex's distance
    equals ``fl(lo + Δ)`` exactly, the top edge of the bucket ``[lo,
    lo + Δ)`` just emptied, and ``fl(nxt / Δ)`` rounds to just under 3,
    so ``floor(nxt / Δ) * Δ`` gives back the same ``lo``: the heavy pass
    and an empty light pass then alternate until ``max_iters``.  The
    port does the same, bit for bit."""
    rg = rgen.road_grid(64, seed=5)
    src = int(np.argmax(rg.deg))
    dg = convert.from_reference(ref_arrays(rg), "cpu").to_device("cpu")
    delta = float(rg.max_w)
    ref = _np(ref_delta_stepping(rg.to_device(), src, delta, max_iters=3000))
    out = delta_stepping(dg, src, delta, max_iters=3000)
    assert_same(ref, _port(out), "road_grid(64) at max_w")
    assert ref[2]["n_rounds"] == 3000            # stopped by the cap only
    d = out[0].numpy()
    lo = np.float32(2) * np.float32(delta)        # the stuck bucket's lo
    stuck = np.float32(lo + np.float32(delta))
    assert (d == stuck).any()
    assert np.floor(stuck / np.float32(delta)) * np.float32(delta) == lo
    # the tail of the graph was never reached: Bellman-Ford's was
    assert np.isfinite(bellman_ford(dg, src)[0].numpy()).all()
    assert not np.isfinite(d).all()
