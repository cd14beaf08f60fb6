"""Port parity: the adaptive stepping policy (``repro_torch.core.stepping``
and ``policy="adaptive"`` in ``repro_torch.core.sssp``).

``policy_init`` and ``adaptive_update`` are held bitwise in f32 against
the reference's jitted functions over 200 seeded counter sequences,
among them sequences that drive every parameter to its clamps, which sit
at the f32 roundings of the policy's bounds (``float32(0.995)`` is above
0.995: ROADMAP queue 3 item 3).  Then adaptive solves against the
reference's: dist, parent and the logical counters bitwise on three
graphs, on both backends; and against the static solve: dist and parent
bitwise (windows are pure scheduling).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.generators as rgen
from repro.core import stepping as rstep
from repro.core.config import EngineConfig as RefConfig
from repro.core.sssp import sssp as ref_sssp
from repro_torch import convert
from repro_torch.core import stepping
from repro_torch.core.config import EngineConfig
from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict, sssp
from test_torch_graph import ref_arrays
from release_xla import release_compiled  # noqa: F401

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sequence(rng, kind: str, steps: int = 24):
    """Cumulative (rounds, relax, updates) counters over ``steps`` step
    transitions: random, or driving the policy to a clamp."""
    if kind == "wide":          # many rounds, all waste: shrink to mult_min
        d = np.stack([rng.integers(7, 40, steps), rng.integers(50, 500, steps),
                      np.zeros(steps, np.int64)], axis=1)
    elif kind == "narrow":      # one round, no waste: grow to mult_max
        relax = rng.integers(1, 200, steps)
        d = np.stack([np.ones(steps, np.int64), relax, relax], axis=1)
    else:
        relax = rng.integers(0, 400, steps)
        d = np.stack([rng.integers(0, 12, steps), relax,
                      (relax * rng.random(steps)).astype(np.int64)], axis=1)
    return np.cumsum(d, axis=0).astype(np.int32)


def _port_state(ps):
    return [np.asarray(x.numpy()) for x in ps]


def _ref_state(ps):
    return [np.asarray(x) for x in ps]


@functools.lru_cache(maxsize=None)
def _ref_update():
    return jax.jit(rstep.adaptive_update)


@pytest.mark.parametrize("block", range(4))
def test_adaptive_update_matches_the_reference(block):
    """50 sequences per block (200 in all), each of 24 transitions, from
    the paper's parameters and from random ones: every field of every
    state bitwise equal (f32 bits, int32 snapshots)."""
    rng = np.random.default_rng(100 + block)
    update = _ref_update()
    for k in range(50):
        kind = ("wide", "narrow", "random", "random")[k % 4]
        seq = _sequence(rng, kind)
        params = stepping.SteppingParams() if k % 3 == 0 else \
            stepping.SteppingParams(alpha=float(rng.uniform(0.5, 80)),
                                    beta=float(rng.uniform(0.2, 1.0)))
        r_ps = rstep.policy_init(rstep.SteppingParams(*params))
        p_ps = stepping.policy_init(params)
        for a, b in zip(_ref_state(r_ps), _port_state(p_ps)):
            assert a.tobytes() == b.tobytes() and a.dtype == b.dtype
        for t, (rounds, relax, upd) in enumerate(seq):
            r_ps = update(r_ps, jnp.int32(rounds), jnp.int32(relax),
                          jnp.int32(upd))
            p_ps = stepping.adaptive_update(
                p_ps, *(torch.tensor(v, dtype=torch.int32)
                        for v in (rounds, relax, upd)))
            for name, a, b in zip(stepping.PolicyState._fields,
                                  _ref_state(r_ps), _port_state(p_ps)):
                assert a.tobytes() == b.tobytes(), (block, k, kind, t, name,
                                                    a, b)


def test_adaptive_clamps_at_the_f32_bounds():
    """Hammered either way, the parameters stop at the f32-rounded clamps
    in both packages (``beta`` at float32(0.995), above 0.995), and the
    snapshots advance to the observed counters."""
    pol = stepping.DEFAULT_ADAPTIVE
    update = _ref_update()
    for kind, want in (("wide", dict(mult=F32(pol.mult_min),
                                      alpha=F32(pol.alpha_min),
                                      beta=F32(pol.beta_min))),
                       ("narrow", dict(mult=F32(pol.mult_max),
                                       alpha=F32(pol.alpha_max),
                                       beta=F32(pol.beta_max)))):
        seq = _sequence(np.random.default_rng(7), kind, steps=60)
        params = stepping.SteppingParams(alpha=3.0, beta=0.9)
        r_ps = rstep.policy_init(rstep.SteppingParams(*params))
        p_ps = stepping.policy_init(params)
        for rounds, relax, upd in seq:
            r_ps = update(r_ps, jnp.int32(rounds), jnp.int32(relax),
                          jnp.int32(upd))
            p_ps = stepping.adaptive_update(
                p_ps, *(torch.tensor(v, dtype=torch.int32)
                        for v in (rounds, relax, upd)))
        for name, value in want.items():
            got = getattr(p_ps, name).numpy()
            assert got == value, (kind, name, got, value)
            assert np.asarray(getattr(r_ps, name)) == value
        assert float(F32(pol.beta_max)) > 0.995
        assert int(p_ps.last_rounds) == int(seq[-1][0])


def test_gap_takes_tensor_parameters_and_mult():
    """``gap_from_stats`` with 0-d f32 ``alpha``/``beta`` and ``mult`` as
    the adaptive transition passes them, against the reference."""
    rg = rgen.kronecker(8, 8, seed=3)
    dg = rg.to_device()
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    tg = hg.to_device("cpu")
    rng = np.random.default_rng(5)
    for _ in range(40):
        sd = np.int32(rng.integers(0, 2 * rg.m))
        hd = F32(rng.choice([0.0, 1.0, 3.0, rng.uniform(0, 200)]))
        alpha, beta = F32(rng.uniform(1, 64)), F32(rng.uniform(0.3, 0.995))
        mult = F32(rng.choice([0.25, 1.0, 4.0, rng.uniform(0.25, 4)]))
        ref = rstep.gap_from_stats(
            jnp.int32(sd), jnp.float32(hd), dg.rtow, dg.n_edges2,
            rstep.SteppingParams(jnp.float32(alpha), jnp.float32(beta)),
            jnp.float32(mult))
        t = lambda v: torch.tensor(v)
        port = stepping.gap_from_stats(
            t(sd), t(hd), tg.rtow, tg.n_edges2,
            stepping.SteppingParams(t(alpha), t(beta)), t(mult))
        assert np.asarray(ref).tobytes() == port.numpy().tobytes(), (
            sd, hd, alpha, beta, mult)


ADAPTIVE_GRAPHS = {
    "road12": ("road_grid", dict(side=12, seed=2)),
    "kron8": ("kronecker", dict(scale=8, edge_factor=8, seed=1)),
    "urand": ("uniform_random", dict(n=300, m=2400, seed=3)),
}


@functools.lru_cache(maxsize=None)
def _adaptive_case(name):
    kind, kw = ADAPTIVE_GRAPHS[name]
    rg = getattr(rgen, kind)(**kw)
    src = int(np.argmax(rg.deg))
    ref = ref_sssp(rg.to_device(), src, config=RefConfig(policy="adaptive"))
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    return hg, src, (np.asarray(ref[0]), np.asarray(ref[1]),
                     {f: int(getattr(ref[2], f))
                      for f in LOGICAL_METRIC_FIELDS})


@pytest.mark.parametrize("backend", ["segment_min", "blocked"])
@pytest.mark.parametrize("name", list(ADAPTIVE_GRAPHS))
def test_adaptive_solve_matches_the_reference(name, backend):
    """The port's adaptive solve on each backend against the reference's
    adaptive solve (whose backends agree bitwise, as its own tests hold):
    dist, parent and every logical counter bitwise; dist and parent also
    bitwise the static solve's, with another schedule."""
    hg, src, (d, p, m) = _adaptive_case(name)
    opts = dict(block_v=64, tile_e=64) if backend == "blocked" else {}
    out = sssp(hg, src, device="cpu", backend=backend, policy="adaptive",
               **opts)
    assert np.array_equal(d.view(np.int32), out[0].numpy().view(np.int32))
    assert np.array_equal(p, out[1].numpy())
    got = metrics_dict(out[2])
    assert {f: got[f] for f in LOGICAL_METRIC_FIELDS} == m, name
    static = sssp(hg, src, device="cpu", backend=backend, **opts)
    assert torch.equal(static[0].view(torch.int32),
                       out[0].view(torch.int32))
    assert torch.equal(static[1], out[1])
    assert metrics_dict(static[2])["n_steps"] != got["n_steps"]


def test_adaptive_queries_and_fused_match_the_reference():
    """Adaptive p2p, bounded and knear queries, and the fused adaptive
    solve, against the reference on one graph."""
    rg = rgen.road_grid(12, seed=2)
    dg = rg.to_device()
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    for goal, gp, opts in (("p2p", rg.n - 1, {}), ("bounded", 2.5, {}),
                           ("knear", 9, {}),
                           ("tree", None, dict(backend="blocked",
                                               fused_rounds=2, block_v=64,
                                               tile_e=64))):
        ref = ref_sssp(dg, 5, goal=goal, goal_param=gp,
                       config=RefConfig(policy="adaptive"))
        out = sssp(hg, 5, device="cpu", goal=goal, goal_param=gp,
                   config=EngineConfig(policy="adaptive", **opts))
        assert np.array_equal(np.asarray(ref[0]).view(np.int32),
                              out[0].numpy().view(np.int32)), goal
        assert np.array_equal(np.asarray(ref[1]), out[1].numpy()), goal
        got = metrics_dict(out[2])
        for f in LOGICAL_METRIC_FIELDS:
            assert int(getattr(ref[2], f)) == got[f], (goal, f)
