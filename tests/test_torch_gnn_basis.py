"""DimeNet's basis in the port against the JAX package, bit for bit, on
the CPU: ``core/f32math.py``'s ``sinf``/``cosf`` against the C library's
``sinf``/``cosf`` (which XLA:CPU calls) on 10^6 inputs; ``_sph_jl``,
``_legendre``, ``_y_l0``, ``rbf_basis`` and ``sbf_basis`` against the
reference's jitted functions on draws that include short edges (x down
to 1e-7, where the upward recurrence turns an ulp into garbage); the
geometry (edge lengths, angle cosines) as the reference's jitted
forward computes it.  And reference fault 4 (ROADMAP.md, queue 3): the
recurrence against ``scipy.special.spherical_jn``, an expected failure
that the port reproduces."""
import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

import jax
from repro.models.gnn import dimenet as jdn
from repro_torch.core import f32math
from repro_torch.models.gnn import dimenet
from release_xla import release_compiled  # noqa: F401
from torch_gnn_common import batches, node_graph

CONFIGS = {"smoke": dict(n_spherical=3, n_radial=2),
           "full": dict(n_spherical=7, n_radial=6)}


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _libm(name):
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = getattr(libm, name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def _arguments(n=1_000_000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-119.99, 119.99, n // 2),
                        rng.uniform(-1, 1, n // 4),
                        10.0 ** rng.uniform(-8, 2.07, n // 4),
                        [0.0, -0.0, 0.75, -0.75, 2.0 ** -12, 119.99]])
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["sinf", "cosf"])
def test_sinf_cosf_are_the_c_librarys(name):
    x = _arguments()
    want = np.fromiter(map(_libm(name), x.tolist()), np.float32, len(x))
    got = getattr(f32math, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got), want.view(np.int32))
    # and XLA:CPU's jitted sin/cos are the C library's too
    jfn = jax.jit(jax.numpy.sin if name == "sinf" else jax.numpy.cos)
    assert np.array_equal(_bits(jfn(x)), want.view(np.int32))


def test_sqrt_is_correctly_rounded():
    # against numpy's IEEE root, and from candidates one ulp off (torch's
    # float32 root on a CPU may be one; the correction moves it back)
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(0, 100, 10 ** 6),
                        10.0 ** rng.uniform(-40, 38, 10 ** 6),
                        [0.0, 1e-45, 1e-38, 2.0, 4.0, np.inf]]).astype(
        np.float32)
    want = np.sqrt(x).view(np.int32)
    tx = torch.from_numpy(x)
    assert np.array_equal(_bits(f32math.sqrt(tx)), want)
    exact = torch.from_numpy(np.sqrt(x))
    inf = torch.full_like(exact, float("inf"))
    for off in (torch.nextafter(exact, inf), torch.nextafter(exact, -inf)):
        keep = (tx > 0) & torch.isfinite(tx)
        got = f32math._nearest_root(tx[keep], off[keep])
        assert np.array_equal(_bits(got), want[keep.numpy()])


def test_sinf_refuses_arguments_of_120_and_beyond():
    with pytest.raises(ValueError, match="120"):
        f32math.sinf(torch.tensor([3.0, 120.0]))
    with pytest.raises(ValueError, match="120"):
        f32math.cosf(torch.tensor([-150.0]))


def _short(n=40_000, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(1e-3, 12, n // 2),
                           10.0 ** rng.uniform(-7, 1.3, n // 2)]).astype(
        np.float32)


@pytest.mark.parametrize("l", range(7))
def test_special_functions_are_the_references(l):
    x = _short()
    c = np.random.default_rng(2).uniform(-1, 1, x.shape[0]).astype(
        np.float32)
    tx, tcos = torch.from_numpy(x), torch.from_numpy(c)
    for name, arg, targ in (("_sph_jl", x, tx), ("_legendre", c, tcos),
                            ("_y_l0", c, tcos)):
        want = jax.jit(lambda v: getattr(jdn, name)(l, v))(arg)
        assert np.array_equal(_bits(getattr(dimenet, name)(l, targ)),
                              _bits(want)), name


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_rbf_and_sbf_bases_are_the_references(size):
    jcfg = jdn.DimeNetConfig(**CONFIGS[size])
    tcfg = dimenet.DimeNetConfig(**CONFIGS[size])
    assert np.array_equal(dimenet.bessel_roots(tcfg.n_spherical,
                                               tcfg.n_radial),
                          jdn.bessel_roots(jcfg.n_spherical, jcfg.n_radial))
    d = _short()
    c = np.random.default_rng(3).uniform(-1, 1, d.shape[0]).astype(
        np.float32)
    td, tcos = torch.from_numpy(d), torch.from_numpy(c)
    assert np.array_equal(
        _bits(dimenet.rbf_basis(tcfg, td)),
        _bits(jax.jit(lambda v: jdn.rbf_basis(jcfg, v))(d)))
    got = dimenet.sbf_basis(tcfg, td, tcos)
    assert np.array_equal(
        _bits(got),
        _bits(jax.jit(lambda v, w: jdn.sbf_basis(jcfg, v, w))(d, c)))
    if size == "full":
        # the short edges' garbage (reference fault 4) is reproduced too
        assert float(got.abs().max()) > 1e3


def test_geometry_is_the_reference_forwards(monkeypatch):
    """The edge lengths and the angle cosines that the reference's jitted
    forward hands its bases, captured there by a host callback, against
    the port's; on the 60-node graph with one node moved next to
    another, so that one edge is short."""
    arrays = node_graph()
    pos = arrays["pos"].copy()
    pos[7] = pos[3] + np.float32(1e-4)
    arrays = dict(arrays, pos=pos)
    seen = {}
    rbf, sbf = jdn.rbf_basis, jdn.sbf_basis

    def rbf_spy(cfg, d):
        jax.debug.callback(lambda v: seen.__setitem__("dist", np.array(v)),
                           d)
        return rbf(cfg, d)

    def sbf_spy(cfg, d, cos_t):
        jax.debug.callback(lambda v: seen.__setitem__("cos", np.array(v)),
                           cos_t)
        return sbf(cfg, d, cos_t)
    monkeypatch.setattr(jdn, "rbf_basis", rbf_spy)
    monkeypatch.setattr(jdn, "sbf_basis", sbf_spy)
    jcfg = jdn.DimeNetConfig(d_in=8, n_out=4, graph_level=False, n_blocks=1,
                             d_hidden=16, n_bilinear=2, **CONFIGS["full"])
    jb, tb = batches(arrays)
    jax.block_until_ready(jax.jit(lambda p, b: jdn.forward(jcfg, p, b))(
        jdn.init_params(jcfg, jax.random.PRNGKey(0)), jb))
    vec, dist = dimenet.edge_geometry(tb.pos, tb.senders, tb.receivers)
    cos_t = dimenet.triplet_cos(tb.pos, vec, tb.senders, tb.receivers,
                                tb.triplet_kj, tb.triplet_ji)
    assert float(dist.min()) < 1e-3
    assert np.array_equal(_bits(dist), seen["dist"].view(np.int32))
    assert np.array_equal(_bits(cos_t), seen["cos"].view(np.int32))


@pytest.mark.xfail(strict=True, reason="reference fault 4 (ROADMAP.md, "
                   "queue 3): the upward recurrence is ill-conditioned for "
                   "x < l, and the port reproduces it")
def test_spherical_bessel_matches_scipy():
    from scipy.special import spherical_jn
    x = np.float32([0.1, 0.5, 1.0, 2.0, 4.0])
    for l in range(7):
        np.testing.assert_allclose(
            dimenet._sph_jl(l, torch.from_numpy(x)).numpy(),
            spherical_jn(l, x.astype(np.float64)), rtol=1e-3, atol=1e-6)
