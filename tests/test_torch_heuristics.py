"""Port parity: the stats, stepping and traversal float32 scalars.

The port's heuristics must give the reference's scalars bit for bit on
the same random dist arrays: a one-ulp difference moves a window edge or
a degree bucket and changes the logical counters.  The reference runs
through ``jax.jit`` on the CPU, as its engine does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as rstats, stepping as rstep, \
    traversal as rtrav
from repro_torch.core import f32math
from repro_torch.core import stats as tstats, stepping as tstep, \
    traversal as ttrav
from repro_torch.core.graph import degree_bucket
from release_xla import release_compiled  # noqa: F401


def _case(seed, n=2000):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 300, n).astype(np.int32)
    low = rng.random(n) < 0.3
    deg[low] = rng.integers(1, 4, low.sum())
    dist = (rng.random(n) * 10).astype(np.float32)
    dist[rng.random(n) < 0.25] = np.inf
    w = np.sort(rng.random(5000) * float(rng.uniform(0.5, 8)) + 1e-3)
    rtow = np.quantile(w, np.linspace(0, 1, 4096)).astype(np.float32)
    n_edges2 = np.int32(deg.sum())
    return dist, deg, rtow, n_edges2


_ref_gap = jax.jit(rstep.gap, static_argnames=("params",))
_ref_compute_st = jax.jit(rtrav.compute_st)
_ref_high_d = jax.jit(rstats.high_d)
_ref_ratio = jax.jit(rstep.ratio)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _bits(x):
    return np.asarray(x).astype(np.float32).view(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", range(3))
def test_stats_match_reference(seed):
    dist, deg, rtow, n2 = _case(seed)
    tdist, tdeg = _t(dist), _t(deg)
    for x in (0.0, 2.5, 7.0, np.inf):
        x32 = np.float32(x)
        assert int(rstats.sum_d(dist, deg, x32)) \
            == int(tstats.sum_d(tdist, tdeg, _t(x32)))
        np.testing.assert_array_equal(
            np.asarray(rstats.degree_hist(dist, deg, x32)),
            tstats.degree_hist(tdist, tdeg, _t(x32)).numpy())
        assert _bits(_ref_high_d(dist, deg, x32)) \
            == _bits(tstats.high_d(tdist, tdeg, _t(x32),
                                   degree_bucket(tdeg)))
    for r in np.random.default_rng(seed).random(50).astype(np.float32):
        assert _bits(rstats.max_w_of(jnp.asarray(rtow), r)) \
            == _bits(tstats.max_w_of(_t(rtow), _t(r)))


@pytest.mark.parametrize("ub", [3.0, 9.5, np.inf])
def test_sum_d_grid_matches_reference(ub):
    """Includes ``ub = inf``, where the grid's first point is NaN."""
    dist, deg, _, _ = _case(11)
    ub32 = np.float32(ub)
    rgrid = rtrav.st_grid_points(ub32)
    tgrid = ttrav.st_grid_points(_t(ub32))
    np.testing.assert_array_equal(_bits(rgrid), _bits(tgrid.numpy()))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(rstats.sum_d_grid)(dist, deg, rgrid)),
        tstats.sum_d_grid(_t(dist), _t(deg), tgrid).numpy())


def test_f32math_matches_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([-rng.random(20000) * 80,
                        rng.random(2000) * 80]).astype(np.float32)
    y = np.concatenate([-rng.random(20000) * 0.999999,
                        rng.random(2000) * 5]).astype(np.float32)
    z = np.concatenate([rng.random(20000) * 1e6,
                        np.arange(1, 5000)]).astype(np.float32)
    for ref, port, v in ((jnp.exp, f32math.exp, x),
                         (jnp.log1p, f32math.log1p, y),
                         (jnp.log, f32math.log, z)):
        np.testing.assert_array_equal(_bits(jax.jit(ref)(v)),
                                      _bits(port(_t(v)).numpy()))


@pytest.mark.parametrize("seed", range(2))
def test_stepping_matches_reference(seed):
    dist, deg, rtow, n2 = _case(seed)
    rng = np.random.default_rng(100 + seed)
    p = rng.random(4000).astype(np.float32)
    p[:10] = [0, 1, 1e-7, 1 - 1e-8, 0.5, 0.9, 0.99, 1e-3, 0.3, 0.7]
    hd = (rng.random(4000) * 500).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(_ref_ratio(p, hd)),
        _bits(tstep.ratio(_t(p), _t(hd)).numpy()))
    params = [rstep.SteppingParams(), rstep.SteppingParams(2.0, 0.6)]
    bucket = degree_bucket(_t(deg))
    for prm in params:
        tprm = tstep.SteppingParams(*prm)
        for x in (0.0, 1.5, 4.0, 8.0):
            x32 = np.float32(x)
            ref = _ref_gap(*_j(dist, deg, rtow, n2, x32), params=prm)
            out = tstep.gap(_t(dist), _t(deg), _t(rtow), _t(n2), _t(x32),
                            tprm, bucket)
            assert _bits(ref) == _bits(out), (prm, x)
            sd = np.int32(rng.integers(0, n2 + 1))
            assert _bits(rstep.prob(*_j(sd, n2), prm.beta)) \
                == _bits(tstep.prob(_t(sd), _t(n2), prm.beta))


def test_float32_clamps():
    """The gap floor and the beta cap are float32 values, slightly off
    the decimal literals (compare against ``np.float32``, not float64)."""
    rtow = np.zeros(4096, np.float32)        # degenerate LUT: all zeros
    g = tstep.gap_from_stats(_t(np.int32(0)), _t(np.float32(0.0)),
                             _t(rtow), _t(np.int32(10)))
    assert g.item() >= np.float32(1e-12)
    assert _bits(g) == _bits(rstep.gap_from_stats(
        *_j(np.int32(0), np.float32(0.0), rtow, np.int32(10))))
    p = tstep.prob(_t(np.int32(10)), _t(np.int32(10)), 0.995)
    assert p.item() == np.float32(0.995)


@pytest.mark.parametrize("seed", range(3))
def test_compute_st_matches_reference(seed):
    dist, deg, rtow, n2 = _case(seed)
    bucket = degree_bucket(_t(deg))
    for lb, ub in ((0.0, 1.0), (1.0, 2.5), (3.0, 9.0), (0.0, np.inf),
                   (2.0, 2.0)):
        lb32, ub32 = np.float32(lb), np.float32(ub)
        ref = _ref_compute_st(*_j(dist, deg, rtow, n2, lb32, ub32))
        out = ttrav.compute_st(_t(dist), _t(deg), _t(rtow), _t(n2),
                               _t(lb32), _t(ub32), bucket=bucket)
        assert _bits(ref) == _bits(out), (lb, ub)


def test_profit_terms_match_reference():
    rng = np.random.default_rng(7)
    x = np.sort(rng.random(1024) * 5).astype(np.float32)
    sd = np.sort(rng.integers(0, 10000, 1024))[::-1].astype(np.int32)
    args = (np.float32(4.0), np.float32(6.5), sd, np.int32(1200),
            np.int32(20000), np.float32(1.3))
    ref = jax.jit(rtrav.profit_terms)(x, *args)
    out = ttrav.profit_terms(_t(x), *[_t(a) for a in args])
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
