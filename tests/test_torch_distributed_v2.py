"""Port parity: the sharded v2 and v3 engines at one rank
(``repro_torch.core.distributed``).

Both packages run on byte-identical inputs (the reference's graphs and
layouts, carried over with ``convert.from_reference``), the port under an
in-process gloo group of world size 1, the reference on a one-device
mesh.  Everything is bitwise: ``dist``, ``parent`` and the logical
counters, on both backends, for

* tree solves, unfused and with ``fused_rounds=4`` (grouped rounds on
  ``blocked``, bucket fusion on ``segment_min``);
* the p2p (with and without landmarks), bounded and knear queries;
* traced solves (the records), the adaptive policy and ``config=``;
* batches (``sssp_distributed_batch`` at v1, v2 and v3, per-slot goal
  parameters), each slot also bitwise its scalar solve;
* the known reference fault (ROADMAP queue 3 item 1), reproduced at v2;
* the exchange's packed-key minimum against ``combine_block_partials``.

v3 at one rank takes its compact exchange while the rounds are narrow;
a small ``capacity`` makes it take both paths, with v2's results.  The
engines over 2 and 4 ranks are held in
``tests/test_torch_distributed_v2_ranks.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro.core import distributed as rdist
from repro.core.baselines import dijkstra_host
from repro.core.config import EngineConfig as RefConfig
from repro import obs as robs
from repro_torch import convert, obs
from repro_torch.core import distributed as tdistributed
from repro_torch.core.config import ConfigError, EngineConfig
from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS
from test_torch_distributed import (GRAPHS, _assert_same, _graph,
                                    _layouts, _port_out, _query_args,
                                    _ref_out)
from test_torch_graph import ref_arrays
from test_torch_obs import assert_trace_equal, assert_untraced_equal
from test_torch_sssp import _property_graph
from release_xla import release_compiled  # noqa: F401

VERSIONS = ("v2", "v3")
BACKENDS = ("segment_min", "blocked")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def gloo_one(tmp_path):
    """A gloo process group of world size 1 in this process."""
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    yield
    tdist.destroy_process_group()


def _mesh():
    return jax.make_mesh((1,), ("graph",))


def _both(name, backend, **kw):
    """The reference's and the port's solve of ``name`` from its
    max-degree source at one rank, on ``backend``, with ``kw``."""
    rg, _ = _graph(name)
    rsg, ref_layout, tsg, _, carried = _layouts(name, 1)
    src = kw.pop("source", int(np.argmax(rg.deg)))
    port_kw = kw.pop("port_kw", {})
    ref_kw = kw.pop("ref_kw", {})
    blocked = backend == "blocked"
    if "config" not in ref_kw:      # a config carries the backend itself
        kw["backend"] = backend
    want = rdist.sssp_distributed(
        rsg, src, _mesh(), ("graph",), **kw, **ref_kw,
        **({"blocked": ref_layout} if blocked else {}))
    got = tdistributed.sssp_distributed(
        tsg, src, device="cpu", **kw, **port_kw,
        **({"blocked": carried} if blocked else {}))
    return want, got


@pytest.mark.parametrize("ranks", [1, 2, 4, 7])
def test_packed_key_minimum_is_combine_block_partials(ranks):
    """v2's exchange reduces ``bits(val) << 32 | winner`` keys with MIN;
    over the ranks' rows that is ``combine_block_partials`` (the smallest
    value, then the smallest winner among the ranks that reach it), the
    port's and the reference's, on values with ties and +inf."""
    import jax.numpy as jnp
    from repro.core import relax as rrelax
    from repro_torch.core import relax as trelax
    rng = np.random.default_rng(ranks)
    vals = (rng.integers(0, 4, (ranks, 500)) / 2).astype(np.float32)
    vals[rng.random(vals.shape) < 0.3] = np.inf
    wins = rng.integers(0, 2 ** 31 - 1, vals.shape).astype(np.int32)
    wins[vals == np.inf] = trelax.INT_MAX
    t = lambda a: torch.from_numpy(a)
    keys = tdistributed._pack(t(vals), t(wins)).min(dim=0).values
    best, winner = tdistributed._unpack(keys)
    for want in (trelax.combine_block_partials(t(vals), t(wins)),
                 rrelax.combine_block_partials(jnp.asarray(vals),
                                               jnp.asarray(wins))):
        assert np.asarray(want[0]).tobytes() == best.numpy().tobytes()
        assert np.array_equal(np.asarray(want[1]), winner.numpy())


@pytest.mark.parametrize("fused", [0, 4])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_tree_matches_reference_at_one_rank(name, version, backend, fused,
                                            gloo_one):
    tdistributed.EXCHANGES.reset()
    want, got = _both(name, backend, version=version, fused_rounds=fused)
    want, got = _ref_out(want), _port_out(got)
    _assert_same(want, got, f"{name} {version}/{backend} fused={fused}")
    ex = tdistributed.EXCHANGES.as_dict()
    assert ex["dense"] + ex["compact"] > 0
    if version == "v2":
        assert ex["compact"] == 0
    else:
        # one rank: block = n_pad, so the narrow rounds go compact
        assert ex["compact"] > 0
    if backend == "blocked":
        assert 0 < got[2]["n_tiles_scanned"] < got[2]["n_tiles_dense"]
        if not fused:
            # one launch a kept round, as the reference counts
            assert got[2]["n_invocations"] == want[2]["n_invocations"]
    else:
        assert got[2]["n_invocations"] == 0
    if fused and backend == "blocked":
        # grouped rounds: the unfused engine's results, fewer reads
        _, plain = _both(name, backend, version=version)
        plain = _port_out(plain)
        _assert_same(plain, got, f"{name} {version} grouped vs unfused")
        assert got[2]["n_host_syncs"] < plain[2]["n_host_syncs"] \
            or version == "v3"


@pytest.mark.parametrize("query", ["p2p", "p2p-alt", "bounded", "knear"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_queries_match_reference_at_one_rank(name, version, backend, query,
                                             gloo_one):
    s, goal, gp, rset, tset = _query_args(name, query)
    want, got = _both(name, backend, version=version, source=s, goal=goal,
                      goal_param=gp, ref_kw=dict(landmarks=rset),
                      port_kw=dict(landmarks=tset))
    want, got = _ref_out(want), _port_out(got)
    _assert_same(want, got, f"{name} {version}/{backend} {query}={gp}")
    if query == "p2p-alt":
        assert got[2]["n_pruned"] > 0
        _, plain = _both(name, backend, version=version, source=s,
                         goal="p2p", goal_param=gp)
        plain = _port_out(plain)
        assert got[0][gp].tobytes() == plain[0][gp].tobytes()
        assert got[2]["n_relax"] < plain[2]["n_relax"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_trace_matches_reference_at_one_rank(name, version, backend,
                                             gloo_one):
    cfg = dict(tier="sharded", shard_version=version, shard_backend=backend,
               trace=True, trace_capacity=64)
    want, got = _both(name, backend, ref_kw=dict(config=RefConfig(**cfg)),
                      port_kw=dict(config=EngineConfig(**cfg)))
    what = f"{name} {version}/{backend}"
    trace = obs.materialize_trace(got[3])
    assert_trace_equal(robs.materialize_trace(want[3]), trace, what)
    _, plain = _both(name, backend, version=version)
    assert_untraced_equal(got, plain, what)
    # the records' counters add up to the metrics
    m, sums = _port_out(got[:3])[2], trace.counter_sums()
    if not trace.dropped:
        for f in LOGICAL_METRIC_FIELDS:
            assert sums[f] + (f == "n_extended") == m[f], (what, f)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_adaptive_policy_matches_reference_at_one_rank(name, version,
                                                       backend, gloo_one):
    want, got = _both(name, backend, version=version, policy="adaptive")
    got = _port_out(got)
    _assert_same(_ref_out(want), got, f"{name} {version}/{backend} adaptive")
    # windows are pure scheduling: the static solve's dist and parent
    _, static = _both(name, backend, version=version)
    static = _port_out(static)
    assert got[0].tobytes() == static[0].tobytes()
    assert got[1].tobytes() == static[1].tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
def test_config_equals_the_loose_keywords(version, backend, gloo_one):
    """``config=`` (an EngineConfig or a resolved one) runs what the loose
    keywords run; both at once raise, as in the reference."""
    _, _, tsg, _, carried = _layouts("kron8", 1)
    src = int(np.argmax(_graph("kron8")[1].deg))
    lay = {"blocked": carried} if backend == "blocked" else {}
    cfg = EngineConfig(tier="sharded", shard_version=version,
                       shard_backend=backend, fused_rounds=4, alpha=6.0)
    loose = _port_out(tdistributed.sssp_distributed(
        tsg, src, version=version, backend=backend, fused_rounds=4,
        alpha=6.0, device="cpu", **lay))
    for c in (cfg, cfg.resolve(n=tsg.n_true, m=tsg.n_edges2, n_devices=1)):
        got = _port_out(tdistributed.sssp_distributed(
            tsg, src, config=c, device="cpu", **lay))
        _assert_same(loose, got, f"{version}/{backend} config")
    with pytest.raises(ConfigError, match="not alongside"):
        tdistributed.sssp_distributed(tsg, src, config=cfg, version=version,
                                      device="cpu")
    with pytest.raises(ConfigError, match="needs"):
        tdistributed.sssp_distributed(tsg, src, config=EngineConfig(
            tier="single"), device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_v3_small_capacity_takes_both_paths(name, backend, gloo_one):
    """With room for 8 candidates a block, wide rounds overflow to the
    dense exchange and narrow ones go compact; the result is v2's, and
    the reference's at the same capacity."""
    want, v2 = _both(name, backend, version="v2")
    tdistributed.EXCHANGES.reset()
    want3, v3 = _both(name, backend, version="v3", capacity=8)
    ex = tdistributed.EXCHANGES.as_dict()
    assert ex["dense"] > 0 and ex["compact"] > 0, ex
    v3 = _port_out(v3)
    _assert_same(_port_out(v2), v3, f"{name}/{backend} v3 capacity 8")
    _assert_same(_ref_out(want3), v3, f"{name}/{backend} reference v3")
    # one host read of the overflow flag per exchange
    n_ex = ex["dense"] + ex["compact"]
    assert v3[2]["n_host_syncs"] == _port_out(v2)[2]["n_host_syncs"] + n_ex


@functools.lru_cache(maxsize=None)
def _batch_case(name):
    """Four sources (the max-degree vertex and three seeded ones) and, per
    slot, a p2p target and a knear k."""
    rg, _ = _graph(name)
    rng = np.random.default_rng(7)
    srcs = [int(np.argmax(rg.deg))] + rng.choice(rg.n, 3,
                                                 replace=False).tolist()
    return (srcs, rng.choice(rg.n, 4, replace=False).tolist(),
            [3, 12, 1, 30])


@pytest.mark.parametrize("goal", ["tree", "p2p", "knear"])
@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_slots_are_the_scalar_solves(backend, version, goal,
                                           gloo_one):
    name = "road16"
    rsg, ref_layout, tsg, _, carried = _layouts(name, 1)
    srcs, targets, ks = _batch_case(name)
    gps = {"tree": None, "p2p": targets, "knear": ks}[goal]
    blocked = backend == "blocked"
    kw = dict(version=version, backend=backend, goal=goal)
    want = rdist.sssp_distributed_batch(
        rsg, np.asarray(srcs, np.int32), _mesh(), ("graph",),
        goal_params=gps, **kw, **({"blocked": ref_layout} if blocked
                                  else {}))
    lay = {"blocked": carried} if blocked else {}
    dist, parent, metrics = tdistributed.sssp_distributed_batch(
        tsg, srcs, goal_params=gps, device="cpu", **kw, **lay)
    assert dist.shape == (len(srcs), tsg.deg.size)
    for i, s in enumerate(srcs):
        slot = _port_out((dist[i], parent[i],
                          type(metrics)(*(m[i] for m in metrics))))
        what = f"{backend} {version} {goal} slot {i}"
        _assert_same(_ref_out((want[0][i], want[1][i],
                               type(want[2])(*(m[i] for m in want[2])))),
                     slot, what)
        one = _port_out(tdistributed.sssp_distributed(
            tsg, s, goal_param=None if gps is None else gps[i],
            device="cpu", **kw, **lay))
        _assert_same(one, slot, what + " vs its scalar solve")
        assert slot[2]["n_host_syncs"] == one[2]["n_host_syncs"]


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_a_kept_device_shard_gives_the_same_solves(backend, version,
                                                  gloo_one, monkeypatch):
    """``shard=`` (a :func:`device_shard` kept by the caller) gives the
    solves and batches made without it, bit for bit, and copies nothing
    to the device; without it a batch copies the shard once, not once a
    source."""
    _, _, tsg, _, carried = _layouts("road16", 1)
    srcs, _, ks = _batch_case("road16")
    lay = {"blocked": carried} if backend == "blocked" else {}
    kw = dict(version=version, backend=backend, device="cpu")
    shard = tdistributed.device_shard(tsg, carried, device="cpu")
    built = []
    init = tdistributed.DeviceShard.__init__
    monkeypatch.setattr(tdistributed.DeviceShard, "__init__",
                        lambda self, *a: built.append(1) or init(self, *a))
    for s, k in zip(srcs, ks):
        want = _port_out(tdistributed.sssp_distributed(
            tsg, s, goal="knear", goal_param=k, **kw, **lay))
        got = _port_out(tdistributed.sssp_distributed(
            tsg, s, goal="knear", goal_param=k, shard=shard, **kw))
        _assert_same(want, got, f"{backend} {version} source {s}")
    want = tdistributed.sssp_distributed_batch(tsg, srcs, **kw, **lay)
    assert len(built) == len(srcs) + 1
    got = tdistributed.sssp_distributed_batch(tsg, srcs, shard=shard, **kw)
    assert len(built) == len(srcs) + 1
    for a, b in zip(want[:2], got[:2]):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    for a, b in zip(want[2], got[2]):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_a_kept_device_shard_is_checked(gloo_one):
    _, _, tsg, _, carried = _layouts("road16", 1)
    _, _, other, _, _ = _layouts("kron8", 1)
    plain = tdistributed.device_shard(tsg, device="cpu")
    shard = tdistributed.device_shard(tsg, carried, device="cpu")
    call = tdistributed.sssp_distributed
    with pytest.raises(ValueError, match="another graph"):
        call(other, 0, shard=shard, device="cpu")
    with pytest.raises(ValueError, match="blocked layout"):
        call(tsg, 0, backend="blocked", shard=plain, device="cpu")
    for kw in (dict(blocked=carried), dict(block_v=64)):
        with pytest.raises(ValueError, match="carries the layout"):
            call(tsg, 0, backend="blocked", shard=shard, device="cpu", **kw)
    # a segment_min solve reads the edge slab of either
    a = _port_out(call(tsg, 0, shard=plain, device="cpu"))
    b = _port_out(call(tsg, 0, shard=shard, device="cpu"))
    _assert_same(a, b, "segment_min on either shard")


def test_batch_arguments_are_checked(gloo_one):
    _, _, tsg, _, _ = _layouts("road16", 1)
    for kw in (dict(sources=[]), dict(sources=[[0, 1]]),
               dict(sources=[0, 1], goal="knear", goal_params=[3]),
               dict(sources=[0, tsg.n_true])):
        with pytest.raises(ValueError):
            tdistributed.sssp_distributed_batch(tsg, device="cpu", **kw)


def test_batch_trace_is_one_ring_a_slot(gloo_one):
    _, _, tsg, _, _ = _layouts("kron8", 1)
    cfg = EngineConfig(tier="sharded", trace=True, trace_capacity=32)
    out = tdistributed.sssp_distributed_batch(tsg, [0, 5], config=cfg,
                                              device="cpu")
    traces = obs.materialize_trace(out[3])
    assert len(traces) == 2
    for i, s in enumerate((0, 5)):
        one = tdistributed.sssp_distributed(tsg, s, config=cfg,
                                            device="cpu")
        want = obs.materialize_trace(one[3])
        assert_trace_equal(want, traces[i], f"slot {i}")


@functools.lru_cache(maxsize=1)
def _seed_3679():
    """The random graph on which the reference drops a candidate equal to
    ``ub`` (ROADMAP queue 3 item 1), in both packages, with its source."""
    rg, src = _property_graph(3679)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    return rg, hg, src


def _seed_3679_solves():
    rg, hg, src = _seed_3679()
    want = rdist.sssp_distributed(rdist.shard_graph(rg, 1), src, _mesh(),
                                  ("graph",), version="v2")
    got = tdistributed.sssp_distributed(tdistributed.shard_graph(hg, 1), src,
                                        version="v2", device="cpu")
    n = hg.n
    return ((np.asarray(want[0])[:n], np.asarray(want[1])[:n], want[2]),
            (got[0][:n], got[1][:n], got[2]))


def test_v2_reproduces_the_reference_fault_bitwise(gloo_one):
    want, got = _seed_3679_solves()
    _assert_same(_ref_out(want), _port_out(got), "seed 3679 v2")


@pytest.mark.xfail(strict=True, reason="known reference fault (ROADMAP "
                   "queue 3 item 1): a candidate equal to ub is dropped")
def test_v2_reference_fault_against_dijkstra(gloo_one):
    rg, _, src = _seed_3679()
    _, got = _seed_3679_solves()
    ref, _ = dijkstra_host(rg, src)
    d = got[0].numpy()
    np.testing.assert_allclose(np.where(np.isfinite(d), d, -1),
                               np.where(np.isfinite(ref), ref, -1),
                               rtol=1e-4, atol=1e-5)
