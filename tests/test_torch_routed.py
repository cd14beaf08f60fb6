"""Port parity: the routed tier of the facade
(``Solver(EngineConfig(tier="routed"))`` in ``repro_torch.api``).

Mirrors the routed parts of ``tests/test_api.py`` on the CPU: every goal
kind, scalar and batched, bitwise the reference's routed facade (its
finalized answers: dist, parent, the logical metrics); lazy shaping;
``submit`` (one aggregate ``Future``, the router's workers started
lazily and joined by ``close``), a slot's exception reaching that
future, a sharded-tier graph behind the routed tier (one gloo rank);
``apply_delta`` against the reference's routed tier.
"""
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro.api import EngineConfig as RefConfig
from repro.api import SolveSpec as RefSpec
from repro.api import Solver as RefSolver
from repro.delta import EdgeDelta as RefDelta
from repro_torch.api import ConfigError, EngineConfig, SolveSpec, Solver
from repro_torch.core.sssp import sssp
from repro_torch.delta import EdgeDelta
from torch_serve_common import CPU, LOGICAL_KEYS, graph, port
from release_xla import release_compiled  # noqa: F401

SIDE = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _kind_specs(mod, n):
    S = mod
    return [S.tree(0), S.p2p(0, n - 1), S.bounded(0, 2.5), S.knear(0, 5),
            S.tree([0, 5, 9]), S.p2p([0, 5], [n - 1, 30])]


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
def test_routed_tier_matches_the_reference_facade(backend):
    """``Solver(tier="routed")`` answers every kind, scalar and batched,
    bitwise as the reference's routed facade does (finalized answers)."""
    rg, hg = graph("road_grid", SIDE, seed=5)
    geom = dict(block_v=64, tile_e=64) if backend == "blocked" else {}
    with Solver.open(hg, EngineConfig(tier="routed", max_batch=2,
                                      backend=backend, devices=("cpu",) * 2,
                                      **geom)) as solver, \
            RefSolver.open(rg, RefConfig(tier="routed", max_batch=2,
                                         backend=backend, **geom)) as ref:
        for spec, rspec in zip(_kind_specs(SolveSpec, hg.n),
                               _kind_specs(RefSpec, hg.n)):
            got, want = solver.solve(spec), ref.solve(rspec)
            assert got.tier == "routed" and got.served_by is not None
            np.testing.assert_array_equal(
                np.asarray(got.dist).view(np.int32),
                np.asarray(want.dist).view(np.int32), err_msg=spec.kind)
            np.testing.assert_array_equal(got.parent, want.parent)
            ms = got.metrics if spec.batched else [got.metrics]
            rs = want.metrics if spec.batched else [want.metrics]
            for a, b in zip(ms, rs):
                assert {k: a[k] for k in LOGICAL_KEYS} \
                    == {k: b[k] for k in LOGICAL_KEYS}
        assert solver.router.stats()["n_done"] == 9
        assert solver.registry.engine("default").device == CPU


def test_routed_tier_shaping_submit_and_close():
    hg = port("road_grid", SIDE, seed=5)
    solver = Solver.open(hg, EngineConfig(tier="routed", max_batch=2),
                         device="cpu")
    assert solver.router.n_devices == 1 and solver.device_graph is None
    rb = solver.solve(SolveSpec.tree([0, 5, 9]))
    assert rb.dist.shape == (3, hg.n)
    np.testing.assert_array_equal(rb.dist[2],
                                  sssp(hg, 9, device="cpu")[0].numpy())
    with pytest.raises(ValueError):
        rb.normalized()
    assert rb.normalized(slot=1)["reachable"] > 0
    fut = solver.submit(SolveSpec.p2p([0, 5], [100, 30]))
    res = fut.result(timeout=60)
    assert res.paths()[0][-1] == 100 and len(res.served_by) == 2
    assert solver.router.schedulers[0]._worker is not None   # started
    many = solver.solve_many([SolveSpec.tree(1), SolveSpec.knear(2, 4)])
    assert [r.spec.kind for r in many] == ["tree", "knear"]
    assert solver.warmup(kinds=("tree",))[0]["batch"] == 2
    with pytest.raises(ValueError):
        solver.solve(SolveSpec.tree(hg.n))
    with pytest.raises(ConfigError, match="drop layout"):
        Solver.open(hg, EngineConfig(tier="routed"), device="cpu",
                    layout=hg.to_device("cpu"))
    solver.close()
    assert solver.router.schedulers[0]._worker is None       # joined
    with pytest.raises(RuntimeError, match="closed"):
        solver.submit(SolveSpec.tree(0))
    single = Solver.open(hg, device="cpu")
    assert single.router is None and single.registry is None
    with pytest.raises(ConfigError, match="routed tier"):
        single.submit(SolveSpec.tree(0))


def test_submit_fails_its_future_when_a_slot_fails(tmp_path):
    """A scheduler's exception reaches the aggregate future (no hang, no
    fallback): here a sharded-tier graph served without a process group,
    whose engine build says so.  With a group (one gloo rank) the same
    submit is served by the sharded tier, bitwise the reference's routed
    facade."""
    rg, hg = graph("road_grid", SIDE, seed=5)
    cfg = dict(tier="routed", shard_threshold_n=100)
    solver = Solver.open(hg, EngineConfig(devices=("cpu",), **cfg))
    assert solver.registry.tier("default") == "sharded"
    fut = solver.submit(SolveSpec.tree([0, 1]))
    with pytest.raises(RuntimeError, match="process group"):
        fut.result(timeout=60)
    solver.close()
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        with Solver.open(hg, EngineConfig(devices=("cpu",), **cfg)) as s, \
                RefSolver.open(rg, RefConfig(**cfg)) as ref:
            for spec, rspec in ((SolveSpec.tree([0, 1]),
                                 RefSpec.tree([0, 1])),
                                (SolveSpec.p2p([0, 5], [100, 30]),
                                 RefSpec.p2p([0, 5], [100, 30]))):
                got = s.submit(spec).result(timeout=60)
                want = ref.solve(rspec)
                assert set(got.served_by) == {"mesh"}
                np.testing.assert_array_equal(
                    np.asarray(got.dist).view(np.int32),
                    np.asarray(want.dist).view(np.int32))
                np.testing.assert_array_equal(got.parent, want.parent)
                for a, b in zip(got.metrics, want.metrics):
                    assert {k: a[k] for k in LOGICAL_KEYS} \
                        == {k: b[k] for k in LOGICAL_KEYS}
    finally:
        tdist.destroy_process_group()


def test_routed_apply_delta_matches_the_reference():
    """``apply_delta`` on the routed tier patches the served engine (no
    rebuild), repairs the cached trees, and later queries serve the
    patched graph, bitwise the reference's routed tier."""
    rg, hg = graph("road_grid", SIDE, seed=5)
    rng = np.random.default_rng(3)
    und = np.flatnonzero(rg.src < rg.dst)
    pick = rng.choice(und, 8, replace=False)
    kw = dict(remove=[(int(rg.src[e]), int(rg.dst[e])) for e in pick[:4]],
              reweight=[(int(rg.src[e]), int(rg.dst[e]), 0.5)
                        for e in pick[4:]], add=[(0, hg.n - 1, 0.25)])
    cfg = dict(tier="routed", max_batch=2, backend="blocked", block_v=64,
               tile_e=64)
    with Solver.open(hg, EngineConfig(devices=("cpu",) * 2, **cfg)) as s, \
            RefSolver.open(rg, RefConfig(**cfg)) as r:
        for x, spec in ((s, SolveSpec), (r, RefSpec)):
            res = x.solve(spec.tree(7))
            x.registry.cache_result(x.gid, 7, res.dist, res.parent)
        got = s.apply_delta(EdgeDelta(**kw))
        want = r.apply_delta(RefDelta(**kw))
        for key in ("n_edits", "engines_patched", "results_repaired",
                    "landmarks"):
            assert got[key] == want[key], key
        d, p = s.registry.cached_result(s.gid, 7)
        rd, rp = r.registry.cached_result(r.gid, 7)
        np.testing.assert_array_equal(d.view(np.int32), rd.view(np.int32))
        np.testing.assert_array_equal(p, rp)
        after = s.submit(SolveSpec.tree(7)).result(timeout=60)
        np.testing.assert_array_equal(after.dist, d)
        np.testing.assert_array_equal(after.parent, p)
        assert s.router.n_rebuilds == 0 and s.registry.stats.builds == 1
        np.testing.assert_array_equal(s.deg, got["host"].deg)
