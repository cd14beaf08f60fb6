"""Port parity: the observability plane (``repro_torch.obs``) and the
engines' per-round traces.

* Traces: a traced solve's ``dist``/``parent``/metrics are bitwise the
  untraced solve's; its records (every column but the physical
  counters, which describe each package's own layout, and those too
  where both count them alike), ``counter_sums`` and ``dropped`` equal
  the reference's for the single-device solve on ``segment_min`` and
  ``blocked``, the fused solve, the adaptive policy, ALT p2p, batched
  solves (one ring per slot) and the v1 engine at one rank; the sums
  plus the initial metrics are the final metrics.
* The facade: ``Solver`` with ``EngineConfig(trace=True)`` returns a
  ``SolveTrace`` (one per slot of a batch, sliced by ``solve_many``).
* Metrics and export: the same operations on both packages'
  ``MetricsRegistry`` give equal snapshots and Prometheus text; the
  strict parser; thread safety; the Perfetto and JSONL exporters.
* Profiling: the dispatch ranges show in a ``torch.profiler`` capture.
"""
import functools
import json
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import repro.data.generators as rgen
from repro import obs as robs
from repro.core import distributed as rdist
from repro.core import landmarks as rlm
from repro.core.config import ConfigError as RefConfigError
from repro.core.config import EngineConfig as RefConfig
from repro.core.sssp import sssp as ref_sssp
from repro.core.sssp import sssp_batch as ref_sssp_batch
from repro_torch import convert, obs
from repro_torch.api import ConfigError, EngineConfig, SolveSpec, Solver
from repro_torch.core import distributed as tdistributed
from repro_torch.core.sssp import (LOGICAL_METRIC_FIELDS, metrics_dict,
                                   sssp, sssp_batch)
from repro_torch.obs.trace import (TRACE_COLUMNS, TRACE_COUNTER_COLUMNS,
                                   TRACE_F32_COLUMNS, TRACE_I32_COLUMNS)
from test_torch_alt_p2p import lm_arrays
from test_torch_graph import ref_arrays
from release_xla import release_compiled  # noqa: F401

PHYSICAL = ("n_tiles_scanned", "n_tiles_dense", "n_invocations")
# the columns both packages fill alike on every path
SHARED = tuple(c for c in TRACE_COLUMNS if c not in PHYSICAL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _graph(name):
    rg = {"kron": lambda: rgen.kronecker(8, 8, seed=2),
          "road": lambda: rgen.road_grid(12, seed=5)}[name]()
    return rg, convert.from_reference(ref_arrays(rg), "cpu")


@functools.lru_cache(maxsize=None)
def _landmarks(name):
    rg, _ = _graph(name)
    rset = rlm.build_landmarks(rg.to_device(), n_landmarks=4)
    return rset, convert.landmarks_from_reference(lm_arrays(rset), "cpu")


def assert_trace_equal(want, got, what, columns=SHARED):
    assert isinstance(got, obs.SolveTrace), what
    assert (want.n_recorded, want.capacity, want.n_records, want.dropped) \
        == (got.n_recorded, got.capacity, got.n_records, got.dropped), what
    for c in columns:
        a, b = want.columns[c], got.columns[c]
        assert a.dtype == b.dtype, (what, c)
        assert a.tobytes() == b.tobytes(), (what, c, a[:8], b[:8])
    sums_w, sums_g = want.counter_sums(), got.counter_sums()
    for c in TRACE_COUNTER_COLUMNS:
        if c in columns:
            assert sums_w[c] == sums_g[c], (what, c)


def assert_sums_are_the_metrics(trace, metrics, what):
    """initial + counter_sums == final, for every traced counter."""
    m = metrics_dict(metrics)
    sums = trace.counter_sums()
    for c in TRACE_COUNTER_COLUMNS:
        assert sums[c] + (1 if c == "n_extended" else 0) == m[c], (what, c)
    assert trace.n_records == int(m["n_host_syncs"]) - 1 or \
        trace.n_records == int(m["n_host_syncs"]), what


def assert_untraced_equal(traced, plain, what):
    assert torch.equal(traced[0].view(torch.int32),
                       plain[0].view(torch.int32)), (what, "dist")
    assert torch.equal(traced[1], plain[1]), (what, "parent")
    for a, b in zip(traced[2], plain[2]):
        assert torch.equal(a, b), what


# ---------------------------------------------------------------------------
# (a) traces of single solves
# ---------------------------------------------------------------------------

# name: (port options, reference config options, columns compared)
SINGLE = {
    "segment_min": (dict(), dict(), TRACE_COLUMNS),
    "blocked": (dict(backend="blocked"), dict(backend="blocked"),
                TRACE_COLUMNS),
    "fused": (dict(backend="blocked", fused_rounds=4),
              dict(backend="blocked", fused_rounds=4), SHARED),
    "adaptive": (dict(policy="adaptive"), dict(policy="adaptive"),
                 TRACE_COLUMNS),
    "small_ring": (dict(trace_capacity=7), dict(trace_capacity=7),
                   TRACE_COLUMNS),
}


@pytest.mark.parametrize("case", list(SINGLE))
@pytest.mark.parametrize("name", ["kron", "road"])
def test_single_solve_trace_matches_reference(name, case):
    rg, hg = _graph(name)
    opts, ref_opts, columns = SINGLE[case]
    src = int(np.argmax(rg.deg))
    *_, rbuf = ref_sssp(rg.to_device(), src,
                        config=RefConfig(trace=True, **ref_opts))
    want = robs.materialize_trace(rbuf)
    out = sssp(hg, src, config=EngineConfig(trace=True, **opts),
               device="cpu")
    got = obs.materialize_trace(out[3])
    assert_trace_equal(want, got, f"{name}/{case}", columns)
    plain_opts = {k: v for k, v in opts.items() if k != "trace_capacity"}
    assert_untraced_equal(out, sssp(hg, src, device="cpu", **plain_opts),
                          f"{name}/{case}")
    if case == "small_ring":
        assert got.dropped > 0 and got.n_records == 7
        assert got.columns["iter"][0] == got.dropped
    else:
        assert got.dropped == 0
        assert_sums_are_the_metrics(got, out[2], f"{name}/{case}")
        assert int(got.columns["stepped"].sum()) >= \
            metrics_dict(out[2])["n_steps"]


@pytest.mark.parametrize("fused", [0, 4])
def test_alt_p2p_trace_matches_reference(fused):
    rg, hg = _graph("kron")
    rset, tset = _landmarks("kron")
    src = int(np.argmax(rg.deg))
    backend = "blocked" if fused else "segment_min"
    for t in (3, 100, 200):
        *_, rbuf = ref_sssp(rg.to_device(), src, goal="p2p", goal_param=t,
                            landmarks=rset, config=RefConfig(
                                trace=True, use_alt=True, backend=backend,
                                fused_rounds=fused))
        cfg = dict(use_alt=True, backend=backend, fused_rounds=fused)
        out = sssp(hg, src, goal="p2p", goal_param=t, landmarks=tset,
                   config=EngineConfig(trace=True, **cfg), device="cpu")
        got = obs.materialize_trace(out[3])
        assert_trace_equal(robs.materialize_trace(rbuf), got, f"alt {t}",
                           SHARED if fused else TRACE_COLUMNS)
        assert_untraced_equal(out, sssp(
            hg, src, goal="p2p", goal_param=t, landmarks=tset,
            config=EngineConfig(**cfg), device="cpu"), f"alt {t}")
        assert got.counter_sums()["n_pruned"] == \
            metrics_dict(out[2])["n_pruned"] > 0


def test_bidirectional_p2p_does_not_trace():
    """As the reference: the meet-in-the-middle mode refuses tracing."""
    rg, hg = _graph("kron")
    _, tset = _landmarks("kron")
    with pytest.raises(ConfigError, match="does not record per-round"):
        sssp(hg, 0, goal="p2p", goal_param=5, landmarks=tset,
             p2p_mode="bidirectional", trace=True, device="cpu")
    with pytest.raises(RefConfigError, match="does not record per-round"):
        rg_ = rg.to_device()
        ref_sssp(rg_, 0, goal="p2p", goal_param=5, landmarks=_landmarks(
            "kron")[0], config=RefConfig(p2p_mode="bidirectional",
                                         use_alt=True, trace=True))


# ---------------------------------------------------------------------------
# (b) batched solves and the v1 engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,goal", [
    ("segment_min", "tree"), ("segment_min", "p2p-alt"), ("blocked", "knear"),
    ("blocked", "p2p-alt"), ("fused", "tree"), ("fused", "p2p-alt")])
def test_batch_trace_matches_reference_per_slot(backend, goal):
    rg, hg = _graph("kron")
    srcs = [int(np.argmax(rg.deg)), 3, 17, 200, 77]
    be = "blocked" if backend != "segment_min" else "segment_min"
    cfg = dict(backend=be, fused_rounds=4 if backend == "fused" else 0)
    kw = {}
    if goal == "knear":
        kw = dict(goal="knear", goal_params=[5, 12, 30, 1, 60])
    elif goal == "p2p-alt":
        kw = dict(goal="p2p", goal_params=[100, 5, 90, 31, 200])
        cfg["use_alt"] = True
    rset, tset = _landmarks("kron")
    rl = dict(landmarks=rset) if goal == "p2p-alt" else {}
    tl = dict(landmarks=tset) if goal == "p2p-alt" else {}
    *_, rbuf = ref_sssp_batch(rg.to_device(), srcs,
                              config=RefConfig(trace=True, **cfg), **kw, **rl)
    out = sssp_batch(hg, srcs, config=EngineConfig(trace=True, **cfg),
                     device="cpu", **kw, **tl)
    got = obs.materialize_trace(out[3])
    want = robs.materialize_trace(rbuf)
    assert len(got) == len(want) == len(srcs)
    columns = SHARED if backend == "fused" else TRACE_COLUMNS
    plain = sssp_batch(hg, srcs, config=EngineConfig(**cfg), device="cpu",
                       **kw, **tl)
    assert_untraced_equal(out, plain, f"{backend}/{goal}")
    for i, (w, g) in enumerate(zip(want, got)):
        assert_trace_equal(w, g, f"{backend}/{goal} slot {i}", columns)
        m = type(out[2])(*(x[i] for x in out[2]))
        sums = g.counter_sums()
        for c in LOGICAL_METRIC_FIELDS:
            assert sums[c] + (c == "n_extended") == int(getattr(m, c)), c


@pytest.fixture
def gloo_one(tmp_path):
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    yield
    tdist.destroy_process_group()


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
@pytest.mark.parametrize("name", ["kron", "road"])
def test_v1_trace_matches_reference_at_one_rank(name, backend, gloo_one):
    rg, hg = _graph(name)
    src = int(np.argmax(rg.deg))
    rsg = rdist.shard_graph(rg, 1)
    *_, rbuf = rdist.sssp_distributed(
        rsg, src, jax.make_mesh((1,), ("graph",)), ("graph",),
        config=RefConfig(tier="sharded", shard_version="v1",
                         shard_backend=backend, trace=True,
                         trace_capacity=64, **(dict(
                             block_v=64, tile_e=64)
                             if backend == "blocked" else {})))
    want = robs.materialize_trace(rbuf)
    tsg = tdistributed.shard_graph(hg, 1)
    opts = dict(version="v1", backend=backend, device="cpu",
                **(dict(block_v=64, tile_e=64) if backend == "blocked"
                   else {}))
    out = tdistributed.sssp_distributed(tsg, src, trace=True,
                                        trace_capacity=64, **opts)
    got = obs.materialize_trace(out[3])
    assert_trace_equal(want, got, f"v1 {name}/{backend}")
    assert_untraced_equal(out, tdistributed.sssp_distributed(tsg, src,
                                                             **opts), "v1")
    if not got.dropped:
        assert_sums_are_the_metrics(got, out[2], "v1")


# ---------------------------------------------------------------------------
# (c) the facade
# ---------------------------------------------------------------------------

def test_solver_returns_traces():
    rg, hg = _graph("kron")
    src = int(np.argmax(rg.deg))
    s = Solver.open(hg, EngineConfig(trace=True, trace_capacity=32),
                    device="cpu")
    one = s.solve(SolveSpec.tree(src))
    direct = obs.materialize_trace(sssp(hg, src, device="cpu", config=(
        EngineConfig(trace=True, trace_capacity=32)))[3])
    assert_trace_equal(direct, one.trace, "single spec", TRACE_COLUMNS)
    batch = s.solve(SolveSpec.tree([src, 5, 9]))
    assert isinstance(batch.trace, list) and len(batch.trace) == 3
    assert_trace_equal(one.trace, batch.trace[0], "slot 0", TRACE_COLUMNS)
    many = s.solve_many([SolveSpec.tree(5), SolveSpec.knear(src, 4),
                         SolveSpec.tree([src, 9])])
    assert_trace_equal(batch.trace[1], many[0].trace, "many 0",
                       TRACE_COLUMNS)
    assert [len(t) for t in many[2].trace] == [len(batch.trace[0]),
                                               len(batch.trace[2])]
    assert isinstance(many[1].trace, obs.SolveTrace)
    plain = Solver.open(hg, device="cpu").solve(SolveSpec.tree(src))
    assert plain.trace is None
    assert torch.equal(plain.dist, one.dist)


# ---------------------------------------------------------------------------
# (d) metrics, Prometheus text, Perfetto and JSONL exports
# ---------------------------------------------------------------------------

def _drive(pkg):
    """The same operations on one package's registry."""
    reg = pkg.MetricsRegistry()
    reg.counter("sssp_queries_total", "queries served",
                {"kind": "p2p"}).inc(3)
    reg.counter("sssp_queries_total", labels={"kind": "tree"}).inc()
    reg.counter("sssp_queries_total", labels={"kind": "p2p"}).inc(2)
    g = reg.gauge("sssp_queue_depth", "pending queries")
    g.set(7)
    g.dec(2)
    g.inc(0.5)
    h = reg.histogram("sssp_solve_seconds", "solve latency",
                      {"tier": "single"})
    for v in (0.0002, 0.003, 0.003, 0.04, 0.6, 7.0, 30.0):
        h.observe(v)
    reg.histogram("sssp_batch_slots", buckets=(1, 2, 4, 8)).observe(3)
    reg.histogram("sssp_empty_seconds")
    return reg


def test_metrics_and_prometheus_match_reference():
    want, got = _drive(robs), _drive(obs)
    assert json.dumps(want.snapshot(), sort_keys=True) == \
        json.dumps(got.snapshot(), sort_keys=True)
    text = obs.to_prometheus(got.snapshot())
    assert text == robs.to_prometheus(want.snapshot())
    parsed = obs.parse_prometheus(text)
    assert parsed == robs.parse_prometheus(text)
    assert parsed['sssp_queries_total{kind="p2p"}'] == 5.0
    assert parsed['sssp_solve_seconds_bucket{le="+Inf",tier="single"}'] \
        == 7.0
    h = got.histogram("sssp_solve_seconds", labels={"tier": "single"})
    for q in (0.5, 0.9, 0.99):
        assert h.percentile(q) == want.histogram(
            "sssp_solve_seconds", labels={"tier": "single"}).percentile(q)
    assert [m.full_name for m in got.metrics()] == \
        [m.full_name for m in want.metrics()]


@pytest.mark.parametrize("bad", [
    lambda r: r.gauge("sssp_queries_total"),              # type clash
    lambda r: r.counter("1bad"),
    lambda r: r.counter("ok", labels={"bad-label": 1}),
    lambda r: r.counter("ok").inc(-1),
    lambda r: r.histogram("h", buckets=(2, 1)),
    lambda r: r.histogram("h2", buckets=())])
def test_registry_rejects_what_the_reference_rejects(bad):
    for pkg in (robs, obs):
        reg = _drive(pkg)
        with pytest.raises(ValueError):
            bad(reg)


@pytest.mark.parametrize("line", [
    "# COMMENT x", "metric", "metric{a=\"1\"} x", "9metric 1",
    "metric 1 2"])
def test_parser_is_strict(line):
    for pkg in (robs, obs):
        with pytest.raises(ValueError):
            pkg.parse_prometheus(line + "\n")
    with pytest.raises(ValueError, match="duplicate"):
        obs.parse_prometheus("a 1\na 2\n")


def test_registry_is_thread_safe():
    reg = obs.MetricsRegistry()
    c = reg.counter("hits_total")
    h = reg.histogram("lat_seconds")

    def work():
        for i in range(2000):
            c.inc()
            h.observe(i * 1e-4)
    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 12000 and h.count == 12000
    snap = reg.snapshot()["lat_seconds"]
    assert snap["buckets"]["+Inf"] == 12000


def test_perfetto_and_jsonl_match_reference(tmp_path):
    rg, hg = _graph("road")
    src = int(np.argmax(rg.deg))
    *_, rbuf = ref_sssp(rg.to_device(), src, config=RefConfig(trace=True))
    want = robs.trace_to_perfetto(robs.materialize_trace(rbuf), name="road")
    trace = obs.materialize_trace(sssp(hg, src, trace=True,
                                       device="cpu")[3])
    got = obs.trace_to_perfetto(trace, name="road")
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    obs.write_perfetto(trace, tmp_path / "t.json", name="road")
    back = json.loads((tmp_path / "t.json").read_text())
    assert back == json.loads(json.dumps(got))
    kinds = {e.get("cat") for e in back["traceEvents"]}
    assert {"solve", "step", "round"} <= kinds
    reg = _drive(obs)
    obs.write_jsonl_snapshot(reg.snapshot(), tmp_path / "m.jsonl",
                             meta={"run": 1})
    obs.write_jsonl_snapshot(reg.snapshot(), tmp_path / "m.jsonl")
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["run"] == 1
    assert json.loads(lines[1])["metrics"] == json.loads(
        json.dumps(reg.snapshot()))


def test_trace_ring_unit():
    """The ring by itself: column order and dtypes, wrap-around, a
    stacked ring written per slot."""
    assert obs.TRACE_COLUMNS == robs.TRACE_COLUMNS
    assert TRACE_I32_COLUMNS + TRACE_F32_COLUMNS == TRACE_COLUMNS
    with pytest.raises(ValueError):
        obs.trace_init(0)
    buf = obs.trace_init(3)
    for i in range(5):
        z = torch.tensor(i, dtype=torch.int32)
        obs.trace_append(buf, {c: z for c in TRACE_I32_COLUMNS},
                         {c: z.float() / 2 for c in TRACE_F32_COLUMNS})
    t = obs.materialize_trace(buf)
    assert (t.n_recorded, t.n_records, t.dropped) == (5, 3, 2)
    assert t.columns["iter"].tolist() == [2, 3, 4]
    assert t.columns["lb"].dtype == np.float32
    assert t.records()[0]["ub"] == 1.0
    stacked = obs.trace_init(4, slots=3)
    v = torch.arange(3, dtype=torch.int32)
    obs.trace_append(stacked, {c: v for c in TRACE_I32_COLUMNS},
                     {c: v.float() for c in TRACE_F32_COLUMNS},
                     rows=torch.tensor([0, 2]))
    per = obs.materialize_trace(stacked)
    assert [p.n_records for p in per] == [1, 0, 1]
    assert per[2].columns["frontier"].tolist() == [2]


# ---------------------------------------------------------------------------
# (e) profiler ranges
# ---------------------------------------------------------------------------

def test_dispatch_ranges_show_in_a_profile():
    assert obs.PROFILER_AVAILABLE
    hg = convert.from_reference(ref_arrays(rgen.road_grid(3, seed=1)),
                                "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        Solver.open(hg, EngineConfig(backend="blocked"),
                    device="cpu").solve(SolveSpec.tree([0, 5]))
        sssp(hg, 0, device="cpu")
    names = {e.key for e in prof.key_averages()}
    for want in ("repro:engine_build:blocked_pallas",
                 "repro:sssp_batch_dispatch", "repro:sssp_dispatch"):
        assert want in names, (want, sorted(n for n in names
                                            if n.startswith("repro:")))
