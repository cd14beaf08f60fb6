"""Port parity: the fused multi-round path (``edge_relax_fused``).

Both packages run on byte-identical inputs: the graphs are the
reference's, carried into the port with ``convert.from_reference``, and
the mid-solve states are made with numpy.  Bitwise parity is required of
the layout's slab (the fused kernel's operands) against the reference's
fused slab, of the plain version against the reference's Pallas kernel
(interpret mode) and its jnp twin (dist, parent, frontier and all eight
``FUSED_COUNTERS``), and of the fused solve against the reference's
fused solve and the port's unfused one.  The CUDA kernel itself is held
against the plain version by ``tests/test_torch_cuda.py`` (on the card
only; that file imports no jax) and by ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.generators as rgen
from repro.core import relax as rrelax
from repro.core.graph import build_blocked as ref_build_blocked
from repro.core.sssp import sssp as ref_sssp
from repro.kernels.edge_relax import ops as rops
from repro_torch import convert
from repro_torch.core.config import ConfigError
from repro_torch.core.graph import build_blocked, build_csr
from repro_torch.core.sssp import (LOGICAL_METRIC_FIELDS, metrics_dict,
                                   sssp)
from repro_torch.kernels.edge_relax import ops, ref
from test_torch_graph import ref_arrays
from release_xla import release_compiled  # noqa: F401

GEOM = dict(block_v=64, tile_e=64)
SLAB_GRAPHS = {"road16": ("road_grid", dict(side=16, seed=2)),
               "kron8": ("kronecker", dict(scale=8, edge_factor=8, seed=1))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the solves here are many tiny ops: threads only add overhead
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _graph(name):
    maker, kwargs = SLAB_GRAPHS[name]
    rg = getattr(rgen, maker)(**kwargs)
    return rg, convert.from_reference(ref_arrays(rg), "cpu")


@pytest.mark.parametrize("name", list(SLAB_GRAPHS))
def test_fused_slab_matches_reference(name):
    # the port's layout stores the slabs concatenated with global source
    # ids, so its own tensors are the reference's fused slab
    rg, hg = _graph(name)
    rfs = rrelax.fused_slab(ref_build_blocked(rg.to_device(), **GEOM))
    bg = build_blocked(hg, device="cpu", **GEOM)
    for f in rfs._fields:
        np.testing.assert_array_equal(np.asarray(getattr(rfs, f)),
                                      getattr(bg, f).numpy(), err_msg=f)


def _mid_solve_state(n, n_out, seed):
    """tests/test_fused_relax.py's mid-solve state: some settled
    vertices, half of them on the frontier, the rest unreached."""
    rng = np.random.default_rng(seed)
    dist = np.full(n_out, np.inf, np.float32)
    seeds = rng.choice(n, min(30, n // 2), replace=False)
    dist[seeds] = rng.uniform(0.0, 3.0, seeds.size).astype(np.float32)
    parent = np.full(n_out, -1, np.int32)
    parent[seeds] = rng.integers(0, n, seeds.size)
    frontier = np.zeros(n_out, bool)
    frontier[seeds[: seeds.size // 2]] = True
    return dist, parent, frontier


@functools.lru_cache(maxsize=None)
def _road12():
    rg = rgen.road_grid(12, seed=2)
    rbg = ref_build_blocked(rg.to_device(), **GEOM)
    return rbg, rrelax.fused_slab(rbg), convert.from_reference(
        ref_arrays(rbg), "cpu")


@pytest.mark.parametrize("fused_rounds", [1, 3])
@pytest.mark.parametrize("window", [(0.0, 1.5), (0.5, 2.5)],
                         ids=["lb0", "mid"])
def test_fused_plain_version_matches_reference(fused_rounds, window):
    rbg, rfs, bg = _road12()
    dist, parent, frontier = _mid_solve_state(rbg.n, bg.n_out, seed=0)
    lb, ub = np.float32(window[0]), np.float32(window[1])
    refs = [rops.relax_fused(
        jnp.asarray(dist), jnp.asarray(parent), jnp.asarray(frontier),
        rbg.deg, rfs.src, rfs.dst, rfs.w, rfs.tile_dst, rfs.tile_first, lb,
        ub, block_v=rbg.block_v, tile_e=rbg.tile_e,
        fused_rounds=fused_rounds, use_kernel=use_kernel)
        for use_kernel in (True, False)]
    t = torch.from_numpy
    out = ops.relax_fused(
        t(dist), t(parent), t(frontier), bg.deg, bg.src, bg.dst, bg.w,
        bg.tile_first, t(np.array(lb)), t(np.array(ub)), tile_e=bg.tile_e,
        fused_rounds=fused_rounds)
    assert out[2].dtype == torch.bool and out[3].dtype == torch.int32
    port = (out[0].numpy().view(np.int32), out[1].numpy(),
            out[2].numpy().astype(np.int32), out[3].numpy())
    for r in refs:
        want = (np.asarray(r[0]).view(np.int32), np.asarray(r[1]),
                np.asarray(r[2]), np.asarray(r[3]))
        for a, b, what in zip(want, port, ("dist", "parent", "frontier",
                                           "counts")):
            np.testing.assert_array_equal(a, b, err_msg=what)
    n_exec = port[3][list(ops.FUSED_COUNTERS).index("n_exec")]
    assert 1 <= n_exec <= (1 if lb <= 0 else fused_rounds)


def _port_solve(hg, src, **opts):
    d, p, m = sssp(hg, src, device="cpu", **opts)
    return d.numpy(), p.numpy(), metrics_dict(m)


@pytest.mark.parametrize("name", list(SLAB_GRAPHS))
def test_fused_solve_matches_reference_and_unfused(name):
    rg, hg = _graph(name)
    src = int(np.argmax(rg.deg))
    rd, rp, rm = ref_sssp(rg.to_device(), src, backend="blocked_pallas",
                          fused_rounds=4, **GEOM)
    fused = _port_solve(hg, src, backend="blocked", fused_rounds=4, **GEOM)
    unfused = _port_solve(hg, src, backend="blocked", **GEOM)
    ref = (np.asarray(rd), np.asarray(rp),
           {f: int(getattr(rm, f)) for f in LOGICAL_METRIC_FIELDS})
    for other, what in ((ref, "reference fused"), (unfused, "port unfused")):
        np.testing.assert_array_equal(other[0].view(np.int32),
                                      fused[0].view(np.int32),
                                      err_msg=f"{what}: dist")
        np.testing.assert_array_equal(other[1], fused[1],
                                      err_msg=f"{what}: parent")
        bad = {f: (other[2][f], fused[2][f]) for f in LOGICAL_METRIC_FIELDS
               if other[2][f] != fused[2][f]}
        assert not bad, (what, bad)
    # the physical counters follow the same layout and rounds
    assert fused[2]["n_tiles_scanned"] == float(rm.n_tiles_scanned)
    assert fused[2]["n_tiles_scanned"] == unfused[2]["n_tiles_scanned"]
    assert fused[2]["n_invocations"] == float(rm.n_invocations)
    assert fused[2]["n_invocations"] < unfused[2]["n_invocations"]
    assert fused[2]["n_host_syncs"] < unfused[2]["n_host_syncs"]
    if name == "road16":          # the round-heavy graph
        assert fused[2]["n_invocations"] * 2 \
            <= unfused[2]["n_invocations"]


def test_fused_rounds_needs_the_blocked_backend():
    """The reference's config checks: fused rounds need a blocked backend
    and a count >= 0 (``ConfigError``, a ``ValueError``); with them, a
    dict is not a config, and the adaptive policy and a traced solve run
    bitwise as the unfused ones (dist and parent)."""
    _, hg = _graph("road16")
    with pytest.raises(ValueError, match="needs a blocked backend"):
        sssp(hg, 0, backend="segment_min", fused_rounds=4, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        sssp(hg, 0, backend="blocked", fused_rounds=-1, device="cpu")
    for later, exc in ((dict(config={}), ConfigError),
                       (dict(policy="adaptive"), None),
                       (dict(trace=True), None)):
        if exc is None:
            fused = sssp(hg, 0, backend="blocked", fused_rounds=4,
                         device="cpu", **later)
            plain = sssp(hg, 0, backend="blocked", device="cpu", **later)
            assert torch.equal(fused[0].view(torch.int32),
                               plain[0].view(torch.int32))
            assert torch.equal(fused[1], plain[1])
            continue
        with pytest.raises(exc):
            sssp(hg, 0, backend="blocked", fused_rounds=4, device="cpu",
                 **later)


def _layout_case(device, *, ties=True, empty_front=False):
    rng = np.random.default_rng(5)
    n, m = 900, 5000
    u = rng.integers(0, n // 2, m)               # upper blocks: no edges
    v = rng.integers(0, n, m)
    keep = u != v
    w = (rng.integers(1, 4, keep.sum()).astype(np.float64) if ties
         else rng.random(keep.sum()) + 1e-3)
    g = build_csr(n, u[keep], v[keep], w)
    bg = build_blocked(g, block_v=256, tile_e=64, device=device)
    dist = rng.integers(0, 5, bg.n_out).astype(np.float32)
    dist[rng.random(bg.n_out) < 0.5] = np.inf
    dist[n:] = np.inf
    parent = np.where(np.isfinite(dist), rng.integers(0, n, bg.n_out),
                      -1).astype(np.int32)
    front = (rng.random(bg.n_out) < 0.3) & np.isfinite(dist)
    if empty_front:
        front[:] = False
    t = lambda a: torch.from_numpy(a).to(device)
    f = lambda x: torch.full((), x, dtype=torch.float32, device=device)
    return (t(dist), t(parent), t(front), bg.deg, bg.src, bg.dst, bg.w,
            bg.tile_first, f(1.0), f(6.0)), dict(tile_e=bg.tile_e)


@pytest.mark.parametrize("fused_rounds", [1, 4])
def test_cpu_tensors_take_the_plain_version(fused_rounds):
    args, kw = _layout_case("cpu")
    ops.LAUNCHES.reset()
    out = ops.relax_fused(*args, fused_rounds=fused_rounds, **kw)
    assert ops.LAUNCHES.edge_relax_fused == 0 and ops.LAUNCHES.edge_relax == 0
    want = ref.edge_relax_fused_ref(*args, fused_rounds=fused_rounds, **kw)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    cnt = out[3].tolist()
    names = list(ops.FUSED_COUNTERS)
    assert 1 <= cnt[names.index("n_exec")] <= fused_rounds
    assert cnt[names.index("n_pruned")] == 0


def test_fused_stops_after_a_round_that_improves_nothing():
    args, kw = _layout_case("cpu", empty_front=True)
    dist, parent, front, cnt = ops.relax_fused(*args, fused_rounds=8, **kw)
    forced = int(args[7].sum())                   # only the forced tiles
    assert cnt.tolist() == [0, 0, 0, 0, 0, forced, 1, 0]
    assert torch.equal(dist, args[0]) and torch.equal(parent, args[1])
    assert not front.any()


def test_fused_other_devices_raise():
    args, kw = _layout_case("cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.relax_fused(*[a.to("meta") for a in args], fused_rounds=2,
                        **kw)
    with pytest.raises(ValueError, match=">= 1"):
        ops.relax_fused(*args, fused_rounds=0, **kw)
