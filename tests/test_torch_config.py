"""Port parity: ``EngineConfig`` (``repro_torch.core.config``).

Every case of ``tests/test_config.py`` that concerns the config itself,
held against the reference: the same exception type and a message
fragment for each conflict, equal resolved fields over a grid of
configs, the ``from_loose`` gate.  Then what is the port's own:
``use_kernel=False`` raises, ``interpret`` selects nothing, device
indices map to CUDA devices.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import repro.core.config as rconfig
import repro.data.generators as rgen
from repro_torch import convert
from repro_torch.core import config as pconfig
from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict, sssp
from test_torch_graph import ref_arrays

# (EngineConfig kwargs, resolve kwargs or None for construction only, the
# message fragment both packages must raise)
CONFLICTS = [
    (dict(tier="bogus"), None, "unknown tier"),
    (dict(shard_version="v9"), None, "unknown shard_version"),
    (dict(backend="nope"), None, "unknown relax backend"),
    (dict(shard_backend="nope"), None, "unknown relax backend"),
    (dict(devices=()), None, "must be non-empty"),
    (dict(max_batch=0), None, "max_batch must be >= 1"),
    (dict(alpha=0.0), None, "alpha must be > 0"),
    (dict(beta=-1.0), None, "beta must be > 0"),
    (dict(tile_e=0), None, "tile_e must be >= 1"),
    (dict(fused_rounds=-1), None, "fused_rounds must be >= 0"),
    (dict(policy="greedy"), None, "unknown policy"),
    (dict(trace_capacity=0), None, "trace_capacity must be >= 1"),
    (dict(delta_staleness_budget=2.0), None, "delta_staleness_budget"),
    (dict(p2p_mode="sideways"), None, "unknown p2p_mode"),
    (dict(landmark_strategy="random"), None, "unknown landmark_strategy"),
    (dict(n_landmarks=0), None, "n_landmarks must be >= 1"),
    (dict(p2p_mode="bidirectional"), None, "needs use_alt=True"),
    (dict(p2p_mode="bidirectional", use_alt=True, policy="adaptive"), None,
     "supports only policy='static'"),
    (dict(p2p_mode="bidirectional", use_alt=True, trace=True), None,
     "does not record per-round solve traces"),
    (dict(shard_threshold_n=100), dict(n_devices=2), "needs the graph size"),
    (dict(backend="segment_min", fused_rounds=4),
     dict(n=10, m=10, n_devices=1), "needs a blocked backend"),
    (dict(shard_backend="blocked"), dict(n=10, m=10, n_devices=1),
     "shard_backend is set"),
    (dict(block_v=64), dict(n=10, m=10, n_devices=1),
     "block_v is blocked-layout geometry"),
    (dict(tier="sharded", use_kernel=True), dict(n=10, m=10, n_devices=1),
     "use_kernel is blocked-layout geometry"),
    (dict(tier="sharded", compact_capacity=8),
     dict(n=10, m=10, n_devices=1), "compact_capacity selects v3"),
    (dict(shard_version="v3", compact_capacity=16),
     dict(n=10, m=10, n_devices=1), "compact_capacity is a sharded-tier"),
    (dict(tier="sharded", shard_threshold_n=5),
     dict(n=10, m=10, n_devices=1), "only apply to tier='auto'"),
    (dict(tier="sharded", backend="blocked_pallas",
          shard_backend="segment_min"), dict(n=10, m=10, n_devices=1),
     "disagree for tier='sharded'"),
    (dict(tier="single", devices=(0, 1)), dict(n=10, m=10, n_devices=2),
     "the single tier runs on one device"),
    (dict(tier="sharded", devices=(999,)), dict(n=10, m=10),
     "out of range"),
    (dict(tier="routed", trace=True), dict(n=10, m=10, n_devices=1),
     "routed serving plane"),
    (dict(tier="sharded", p2p_mode="bidirectional", use_alt=True),
     dict(n=10, m=10, n_devices=1), "runs on the single-device tier"),
    (dict(tier="auto", shard_threshold_n=1, shard_version="v2",
          compact_capacity=4), dict(n=10, m=10, n_devices=1),
     "compact_capacity selects v3"),
]


def _raised(mod, kw, rkw):
    try:
        cfg = mod.EngineConfig(**kw)
        if rkw is not None:
            cfg.resolve(**rkw)
    except Exception as exc:        # the type and message are compared
        return exc
    return None


@pytest.mark.parametrize("kw,rkw,fragment", CONFLICTS,
                         ids=[str(i) for i in range(len(CONFLICTS))])
def test_conflicts_raise_as_the_reference(kw, rkw, fragment):
    ref = _raised(rconfig, kw, rkw)
    port = _raised(pconfig, kw, rkw)
    assert ref is not None and port is not None, (ref, port)
    assert type(ref).__name__ == type(port).__name__ == "ConfigError"
    assert fragment in str(ref) and fragment in str(port), (
        str(ref), str(port))
    assert isinstance(port, ValueError)


GRID = dict(
    backend=["segment_min", "blocked", "blocked_pallas"],
    tier=["auto", "single", "sharded", "routed"],
    policy=["static", "adaptive"],
    fused_rounds=[0, 4],
    use_alt=[False, True],
    block_v=[None, 128],
)


def _resolved_fields(r):
    return {k: v for k, v in dataclasses.asdict(r).items()
            if k not in ("devices", "config")}


def test_resolved_fields_match_the_reference_over_a_grid():
    """Every config of the grid either resolves in both packages to equal
    fields (all but ``devices`` and ``config``) or raises the same
    error in both; auto-tiering by thresholds and the derived shard
    backend included."""
    n_ok = 0
    for values in itertools.product(*GRID.values()):
        kw = dict(zip(GRID, values))
        for rkw in (dict(n=144, m=500, n_devices=1),
                    dict(n=144, m=500, n_devices=2)):
            outs = []
            for mod in (rconfig, pconfig):
                try:
                    outs.append(_resolved_fields(
                        mod.EngineConfig(**kw).resolve(**rkw)))
                except mod.ConfigError as exc:
                    outs.append(("ConfigError", str(exc)))
            assert outs[0] == outs[1], (kw, rkw, outs)
            n_ok += isinstance(outs[0], dict)
    for kw, rkw in ((dict(shard_threshold_n=100), dict(n=144, m=500)),
                    (dict(shard_threshold_n=100), dict(n=64, m=500)),
                    (dict(shard_threshold_m=400), dict(n=64, m=500)),
                    (dict(backend="blocked_pallas", tier="sharded",
                          block_v=64), dict(n=10, m=10, n_devices=2))):
        r, p = (mod.EngineConfig(**kw).resolve(**rkw)
                for mod in (rconfig, pconfig))
        assert _resolved_fields(r) == _resolved_fields(p), kw
    assert n_ok > 100
    # auto without thresholds resolves with no graph size in both
    assert pconfig.EngineConfig().resolve().tier == "single"
    p = pconfig.EngineConfig(backend="blocked_pallas", tier="sharded",
                             block_v=64).resolve(n=10, m=10, n_devices=2)
    assert p.shard_backend == "blocked" and p.n_shards == 2
    assert p.layout_opts() == {"block_v": 64}


def test_from_loose_gate():
    cfg = pconfig.EngineConfig(backend="blocked_pallas")
    assert pconfig.EngineConfig.from_loose(cfg, "engine", backend=None,
                                           alpha=None) is cfg
    with pytest.raises(pconfig.ConfigError, match="through config="):
        pconfig.EngineConfig.from_loose(cfg, "engine", backend="segment_min")
    c = pconfig.EngineConfig.from_loose(
        None, "engine", defaults={"shard_backend": "segment_min"},
        alpha=2.0, backend=None)
    assert c.alpha == 2.0 and c.shard_backend == "segment_min"
    c = pconfig.EngineConfig.from_loose(
        None, "engine", defaults={"shard_backend": "segment_min"},
        shard_backend="blocked")
    assert c.shard_backend == "blocked"
    with pytest.raises(TypeError, match="unknown engine options"):
        pconfig.EngineConfig.from_loose(None, "engine", bogus=1)
    from repro_torch.core.relax import get_backend
    c = pconfig.EngineConfig.from_loose(None, "engine",
                                        backend=get_backend("blocked"))
    assert c.backend == "blocked_pallas"
    # the same gate gives the same config in both packages
    for loose in (dict(alpha=2.0), dict(backend="blocked", tile_e=64),
                  dict(policy="adaptive", max_iters=50)):
        r = rconfig.EngineConfig.from_loose(None, "engine", **loose)
        p = pconfig.EngineConfig.from_loose(None, "engine", **loose)
        assert dataclasses.asdict(r) == dataclasses.asdict(p), loose


def test_resolved_engine_helpers():
    r = pconfig.EngineConfig(backend="blocked", block_v=64, tile_e=32,
                             use_alt=True).resolve(n=10, m=10, n_devices=1)
    assert pconfig.as_resolved(r) is r
    with pytest.raises(pconfig.ConfigError, match="expected EngineConfig"):
        pconfig.as_resolved("segment_min")
    with pytest.raises(pconfig.ConfigError, match="this entry point"):
        r.require("sharded")
    assert r.require("single", "routed") is r
    assert r.trace_cap == 0
    assert pconfig.EngineConfig(trace=True, trace_capacity=9).resolve(
        n_devices=1).trace_cap == 9
    # use_kernel/interpret select nothing and are not passed on
    assert r.layout_opts() == r.blocked_opts() == dict(block_v=64,
                                                       tile_e=32)
    assert pconfig.P2P_MODES == rconfig.P2P_MODES
    assert pconfig.LANDMARK_STRATEGIES == rconfig.LANDMARK_STRATEGIES
    assert pconfig.STEP_POLICIES == rconfig.STEP_POLICIES
    assert issubclass(pconfig.FacadeDeprecationWarning, DeprecationWarning)


def test_use_kernel_false_raises_in_the_port():
    """The reference's switch to its plain path has no counterpart on the
    card: the config refuses it, and ``sssp``'s loose keyword stays an
    unknown option."""
    with pytest.raises(pconfig.ConfigError, match="use_kernel=False"):
        pconfig.EngineConfig(backend="blocked", use_kernel=False)
    rconfig.EngineConfig(backend="blocked", use_kernel=False)   # valid there
    assert pconfig.EngineConfig(backend="blocked", use_kernel=True).resolve(
        n_devices=1).use_kernel is True
    hg = convert.from_reference(ref_arrays(rgen.road_grid(6, seed=1)), "cpu")
    with pytest.raises(TypeError, match="unknown engine options"):
        sssp(hg, 0, device="cpu", use_kernel=False)


def test_interpret_selects_nothing():
    rg = rgen.kronecker(7, 8, seed=2)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    outs = [sssp(hg, 1, device="cpu", config=pconfig.EngineConfig(
        backend="blocked", block_v=64, tile_e=64, interpret=flag))
        for flag in (True, False)]
    assert torch.equal(outs[0][0].view(torch.int32),
                       outs[1][0].view(torch.int32))
    assert torch.equal(outs[0][1], outs[1][1])
    a, b = metrics_dict(outs[0][2]), metrics_dict(outs[1][2])
    assert all(a[f] == b[f] for f in LOGICAL_METRIC_FIELDS)


def test_device_indices_resolve_to_cuda_devices():
    assert pconfig.resolve_devices(None) is None
    assert pconfig.resolve_devices(("cpu",)) == [torch.device("cpu")]
    with pytest.raises(pconfig.ConfigError, match="out of range"):
        pconfig.resolve_devices((999,))
    n_cards = torch.cuda.device_count()
    if n_cards:
        assert pconfig.resolve_devices((0,)) == [torch.device("cuda", 0)]
    else:
        with pytest.raises(pconfig.ConfigError, match="0 visible"):
            pconfig.resolve_devices((0,))
    # a host without a card counts its CPU as one device
    r = pconfig.EngineConfig().resolve(n=10, m=10)
    assert r.n_shards == max(n_cards, 1)


def test_engine_rejects_config_plus_loose_kwargs():
    rg = rgen.road_grid(8, seed=0)
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    cfg = pconfig.EngineConfig().resolve(n=hg.n, m=hg.m, n_devices=1)
    for loose in (dict(backend="segment_min"), dict(alpha=2.0),
                  dict(policy="adaptive"), dict(p2p_mode="unidirectional")):
        with pytest.raises(pconfig.ConfigError, match="through config="):
            sssp(hg, 0, device="cpu", config=cfg, **loose)
    with pytest.raises(pconfig.ConfigError, match="this entry point"):
        sssp(hg, 0, device="cpu", config=pconfig.EngineConfig(
            tier="sharded"))
    # a config and its loose twin solve alike
    a = sssp(hg, 3, device="cpu", config=pconfig.EngineConfig(
        alpha=1.5, beta=0.5, policy="adaptive"))
    b = sssp(hg, 3, device="cpu", alpha=1.5, beta=0.5, policy="adaptive")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert np.isfinite(a[0].numpy()).all()
