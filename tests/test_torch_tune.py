"""Port parity: the auto-tuner (``repro_torch.tune``).

Mirrors ``tests/test_tuner.py`` on the CPU and holds the port against
the reference:

* ``graph_fingerprint`` gives the reference's digest for the same graph,
  host or device form, with and without ALT parameters;
* a ``TunedStore`` file written by either package is read and applied by
  the other (the same JSON format);
* ``tune()`` with a fixed seed and budget gives the reference's
  trajectory row for row (objectives equal as floats, the same accept and
  parity flags, the same winner): on ``segment_min``, where the objective
  reads only logical counters, and on ``blocked`` at the default
  geometry (one source block), where it also reads the physical
  ``n_invocations`` and ``n_tiles_scanned``; the winner's tree is
  bitwise the baseline's.  With several source blocks the reference
  launches its one-round kernel once per slab and the port once per
  round over all slabs, so there the unfused rows' objectives differ by
  4 (the invocation weight) per saved launch, and the rest agree;
* the search's determinism, parity gate and budget on a fake evaluator,
  the JSONL trajectory, ``Solver.open(tuned=)`` and the registry's tuned
  builds; a sharded base (one gloo rank) gives the reference's
  trajectory.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.config import EngineConfig as RefConfig
from repro.tune import TunedStore as RefStore
from repro.tune import graph_fingerprint as ref_fingerprint
from repro.tune import tune as ref_tune
from repro_torch.api import SolveSpec, Solver
from repro_torch.core.config import EngineConfig
from repro_torch.core.graph import build_blocked
from repro_torch.serve.registry import GraphRegistry
from repro_torch.tune import (TUNED_FIELDS, TunedStore, graph_fingerprint,
                              objective_from_counters, trace_objective, tune)
from repro_torch.tune import search as tsearch
from torch_serve_common import gloo_one, graph
from release_xla import release_compiled  # noqa: F401

CFG_FIELDS = TUNED_FIELDS + ("tier", "backend", "max_batch", "use_alt")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def kron():
    return graph("kronecker", 8, 6, seed=4)


@pytest.fixture(scope="module")
def reference(kron):
    res = Solver.open(kron[1], device="cpu").solve(SolveSpec.tree(0))
    return res.dist, res.parent


def fields(cfg) -> dict:
    return {f: getattr(cfg, f) for f in CFG_FIELDS}


@pytest.mark.parametrize("case", ["host", "device", "alt", "alt-bidi",
                                  "road"])
def test_fingerprint_matches_the_reference(case):
    rg, hg = graph("road_grid", 10, seed=5) if case == "road" \
        else graph("kronecker", 8, 6, seed=4)
    kw = {"alt": dict(use_alt=True, n_landmarks=4),
          "alt-bidi": dict(use_alt=True, p2p_mode="bidirectional")}.get(
        case, {})
    g = hg.to_device("cpu") if case == "device" else hg
    want = ref_fingerprint(rg, RefConfig(**kw) if kw else None)
    assert graph_fingerprint(g, EngineConfig(**kw) if kw else None) == want
    if kw:
        assert want != ref_fingerprint(rg)


def test_a_store_is_shared_both_ways(kron, tmp_path):
    rg, hg = kron
    path = tmp_path / "tuned.json"
    RefStore(path).put("ref", rg, RefConfig(alpha=9.0, beta=0.95,
                                            policy="adaptive"),
                       objective=10.0, baseline=20.0, meta={"seed": 1})
    TunedStore(path).put("port", hg, EngineConfig(
        backend="blocked", alpha=6.0, fused_rounds=4, tile_e=128,
        devices=("cpu",)), objective=5.0)
    port_store, ref_store = TunedStore(path), RefStore(path)
    assert port_store.gids() == ref_store.gids() == ["port", "ref"]
    for gid in ("ref", "port"):
        assert port_store.entry(gid) == ref_store.entry(gid)
        assert fields(port_store.get(gid, hg)) \
            == fields(ref_store.get(gid, rg))
    applied = port_store.apply("ref", hg, EngineConfig(max_batch=16))
    assert (applied.alpha, applied.policy, applied.max_batch) \
        == (9.0, "adaptive", 16)
    applied = ref_store.apply("port", rg, RefConfig(backend="blocked_pallas"),
                              n=int(rg.n), m=int(rg.m))
    assert (applied.alpha, applied.fused_rounds, applied.tile_e) \
        == (6.0, 4, 128)
    assert "devices" not in port_store.entry("port")["config"]
    # the file the port rewrites stays the reference's format
    assert port_store.invalidate("ref") and not port_store.invalidate("ref")
    assert RefStore(path).gids() == ["port"]


def test_store_staleness_and_fallbacks(kron, tmp_path):
    rg, hg = kron
    path = tmp_path / "tuned.json"
    path.write_text("{not json")
    store = TunedStore(path)
    assert store.get("kg", hg) is None
    cfg = EngineConfig(alpha=9.0, beta=0.95, policy="adaptive")
    store.put("kg", hg, cfg, objective=10.0, baseline=20.0)
    assert TunedStore(path).get("kg", hg) == cfg
    assert TunedStore(path).get("kg") == cfg
    other = graph("kronecker", 8, 6, seed=9)[1]
    assert TunedStore(path).get("kg", other) is None
    assert TunedStore(path).get("kg", other, allow_stale=True) == cfg
    assert TunedStore(path).apply("kg", other, EngineConfig()) \
        == EngineConfig()
    # ALT-tuned winners are stale when served without ALT
    store.put("alt", hg, EngineConfig(use_alt=True, alpha=5.0))
    assert store.get("alt", hg) is None
    assert store.get("alt", hg, EngineConfig(use_alt=True)).alpha == 5.0
    # an overlay the live config cannot carry falls back to params only
    store.put("f", hg, EngineConfig(backend="blocked", alpha=7.0,
                                    fused_rounds=4))
    applied = store.apply("f", hg, EngineConfig(), n=int(hg.n), m=int(hg.m))
    assert applied.alpha == 7.0 and applied.fused_rounds == 0


TUNE_CASES = {
    "segment_min": (dict(), dict(), dict(budget=8, seed=0, restarts=1)),
    "segment_min-seed3": (dict(), dict(), dict(budget=6, seed=3,
                                               restarts=2)),
    "blocked": (dict(backend="blocked_pallas"), dict(backend="blocked"),
                dict(budget=6, seed=0, restarts=0)),
    "blocked-4-slabs": (dict(backend="blocked_pallas", block_v=64,
                             tile_e=64),
                        dict(backend="blocked", block_v=64, tile_e=64),
                        dict(budget=6, seed=0, restarts=0, space={
                            "fused_rounds": (0, 4), "alpha": (1.5, 6.0),
                            "beta": (0.7, 0.9)})),
}


@pytest.mark.parametrize("case", list(TUNE_CASES))
def test_tune_trajectory_matches_the_reference(case, kron, tmp_path):
    """Row for row the reference's trajectory: the configs, the
    objectives as floats, the accept and parity flags, then the same
    winner, counts and store entry.  The winner's tree is bitwise the
    baseline's."""
    rg, hg = kron
    rkw, pkw, kw = TUNE_CASES[case]
    want = ref_tune(rg, RefConfig(**rkw), n_sources=2,
                    store=RefStore(tmp_path / "ref.json"), gid="kg", **kw)
    got = tune(hg, EngineConfig(**pkw), n_sources=2,
               store=TunedStore(tmp_path / "port.json"), gid="kg",
               device="cpu", **kw)
    assert len(got.trajectory) == len(want.trajectory) > 1
    slabs = case == "blocked-4-slabs"
    for a, b in zip(got.trajectory, want.trajectory):
        if slabs and a["config"]["fused_rounds"] == 0:
            # 4 source blocks: the reference's 4 launches a round, ours 1
            saved = (b["objective"] - a["objective"]) / 4.0
            assert saved >= 1 and abs(saved - round(saved)) < 1e-9, (a, b)
            a = dict(a, objective=b["objective"])
        assert a == b
    for f in ("best_objective", "baseline_objective", "n_evals",
              "n_accepted", "n_parity_rejects", "n_invalid"):
        if not (slabs and f == "baseline_objective"):
            assert getattr(got, f) == getattr(want, f), f
    assert fields(got.best_config) == {
        **fields(want.best_config), "backend": pkw.get("backend",
                                                       "segment_min")}
    assert TunedStore(tmp_path / "port.json").entry("kg")["fingerprint"] \
        == RefStore(tmp_path / "ref.json").entry("kg")["fingerprint"]
    base = Solver.open(hg, EngineConfig(**pkw), device="cpu")
    best = Solver.open(hg, got.best_config, device="cpu")
    for s in (0, int(np.argmax(hg.deg))):
        a, b = base.solve(SolveSpec.tree(s)), best.solve(SolveSpec.tree(s))
        assert a.dist.equal(b.dist) and a.parent.equal(b.parent)


def test_p2p_tune_matches_the_reference(kron):
    rg, hg = kron
    kw = dict(goal="p2p", budget=4, seed=1, restarts=0, n_sources=2,
              space={"use_alt": (False, True), "alpha": (1.5, 6.0)})
    want = ref_tune(rg, **kw)
    got = tune(hg, device="cpu", **kw)
    assert got.trajectory == want.trajectory
    assert got.best_objective == want.best_objective


def _fake_evaluate(n, *, break_alpha=None):
    def fake(graph, config, sources, weights, trace_capacity, **_):
        dist = np.zeros((len(sources), n), np.float32)
        parent = np.full((len(sources), n), -1, np.int32)
        if break_alpha is not None and config.alpha == break_alpha:
            dist = dist + 1.0
        obj = (abs(config.alpha - 6.0) + abs(config.beta - 0.7)
               + (0.5 if config.policy == "adaptive" else 0.0) + 1.0)
        return dist, parent, obj
    return fake


def test_tuner_seed_determinism_and_budget(kron, monkeypatch):
    hg = kron[1]
    monkeypatch.setattr(tsearch, "_evaluate", _fake_evaluate(int(hg.n)))
    a = tune(hg, budget=20, seed=7, restarts=2, device="cpu")
    b = tune(hg, budget=20, seed=7, restarts=2, device="cpu")
    assert a.trajectory == b.trajectory and a.best_config == b.best_config
    assert (a.best_config.alpha, a.best_config.beta,
            a.best_config.policy) == (6.0, 0.7, "static")
    assert a.improved and a.reduction > 0
    assert tune(hg, budget=5, seed=0, restarts=3, device="cpu").n_evals <= 5
    with pytest.raises(ValueError, match="goal"):
        tune(hg, goal="bounded", device="cpu")


def test_tuner_rejects_parity_breaking_candidate(kron, monkeypatch):
    hg = kron[1]
    monkeypatch.setattr(tsearch, "_evaluate",
                        _fake_evaluate(int(hg.n), break_alpha=6.0))
    res = tune(hg, budget=20, seed=0, device="cpu")
    assert res.n_parity_rejects >= 1 and res.best_config.alpha != 6.0
    broken = [r for r in res.trajectory if r["config"]["alpha"] == 6.0]
    assert broken and not any(r["accepted"] or r["parity"] for r in broken)


def test_real_tune_persists_and_logs(kron, tmp_path):
    hg = kron[1]
    store = TunedStore(tmp_path / "tuned.json")
    jsonl = tmp_path / "tuner.jsonl"
    res = tune(hg, budget=5, seed=0, restarts=0, n_sources=2, store=store,
               gid="g8", jsonl_path=str(jsonl), device="cpu")
    assert res.best_objective <= res.baseline_objective
    assert res.n_parity_rejects == 0
    assert store.get("g8", hg) == res.best_config
    entry = store.entry("g8")
    assert entry["objective"] == pytest.approx(res.best_objective)
    assert entry["meta"]["n_evals"] == res.n_evals
    lines = [json.loads(s) for s in jsonl.read_text().splitlines()]
    assert sum(l.get("kind") == "tuner_candidate" for l in lines) \
        == res.n_evals
    assert lines[-1]["kind"] == "tuner_summary"
    assert lines[-1]["metrics"]["sssp_tuner_candidates_total"]["value"] \
        == res.n_evals


def test_trace_objective_and_layout_reuse(kron):
    """The objective reads a traced solve's counter sums; a prebuilt
    blocked layout serves every candidate of its geometry, with the
    same trajectory as building one per candidate."""
    hg = kron[1]
    res = Solver.open(hg, EngineConfig(trace=True, trace_capacity=512),
                      device="cpu").solve(SolveSpec.tree(0))
    sums = res.trace.counter_sums()
    assert trace_objective(res.trace) == objective_from_counters(sums)
    assert trace_objective(res.trace) >= float(sums["n_rounds"])
    assert objective_from_counters({}) == 0.0
    base = EngineConfig(backend="blocked", block_v=64, tile_e=64)
    kw = dict(budget=4, seed=0, restarts=0, n_sources=1, device="cpu",
              space={"alpha": (6.0,), "tile_e": (64, 128)})
    layout = build_blocked(hg.to_device("cpu"), block_v=64, tile_e=64)
    opened = []
    real = Solver.open

    def spy(graph, config=None, **k):
        opened.append((config.tile_e, k.get("layout") is layout))
        return real(graph, config, **k)

    try:
        Solver.open = spy
        a = tune(hg, base, layout=layout, **kw)
    finally:
        Solver.open = real
    b = tune(hg, base, **kw)
    assert a.trajectory == b.trajectory
    # tile_e 128 builds its own layout; every other candidate reuses it
    assert {(t, reused) for t, reused in opened} == {(64, True),
                                                     (128, False)}


def test_solver_open_tuned_overlay(kron, reference, tmp_path):
    d_ref, p_ref = reference
    hg = kron[1]
    path = tmp_path / "tuned.json"
    TunedStore(path).put("kg", hg, EngineConfig(alpha=12.0,
                                                policy="adaptive"))
    s = Solver.open(hg, tuned=str(path), gid="kg", device="cpu")
    assert s.config.alpha == 12.0 and s.config.policy == "adaptive"
    res = s.solve(SolveSpec.tree(0))
    assert res.dist.equal(d_ref) and res.parent.equal(p_ref)
    other = graph("kronecker", 8, 6, seed=9)[1]
    assert Solver.open(other, tuned=str(path), gid="kg",
                       device="cpu").config == EngineConfig()
    routed = Solver.open(hg, EngineConfig(tier="routed"), tuned=str(path),
                         gid="kg", device="cpu")
    assert routed.config == EngineConfig(tier="routed")
    assert routed.registry.tuned is routed._tuned
    assert routed.registry.engine("kg").alpha == 12.0
    routed.close()


def test_registry_builds_from_tuned_store(kron, reference, tmp_path):
    d_ref, p_ref = reference
    hg = kron[1]
    store = TunedStore(tmp_path / "tuned.json")
    store.put("kg", hg, EngineConfig(alpha=12.0, beta=0.99,
                                     policy="adaptive"))
    reg = GraphRegistry(config=EngineConfig(), tuned=store, device="cpu")
    reg.register("kg", hg)
    eng = reg.engine("kg")
    assert eng.alpha == 12.0 and eng.policy == "adaptive"
    assert reg._tuned_builds.value == 1
    dist, parent, _ = eng.run_batch([0])
    assert dist[0].equal(d_ref) and parent[0].equal(p_ref)
    reg.register("plain", hg)
    assert reg.engine("plain").alpha == EngineConfig().alpha
    assert reg._tuned_builds.value == 1


def test_sharded_base_raises_naming_item_10(kron, gloo_one):
    """A sharded base tunes through the port's sharded tier (one gloo
    rank): the reference's trajectory on its one-device mesh, row for
    row, bucket-fusion candidates included."""
    rg, hg = kron
    kw = dict(budget=5, seed=0, restarts=0, n_sources=2)
    want = ref_tune(rg, RefConfig(tier="sharded"), **kw)
    got = tune(hg, EngineConfig(tier="sharded"), device="cpu", **kw)
    assert len(got.trajectory) == len(want.trajectory) > 1
    assert got.trajectory == want.trajectory
    assert got.best_objective == want.best_objective
    assert fields(got.best_config) == fields(want.best_config)
