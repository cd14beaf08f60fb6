"""The frozen generators and the harness's CSR against the port's
``build_csr`` (the same arrays, ``rtow`` included), on the CPU."""
import numpy as np
import pytest
import torch

from bench.graphs import csr, rmat, urand
from repro_torch import build_csr

KRON = {"scale": 8, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
        "weights": "uniform_0_1", "structure_seed": 3}
URAND = {"scale": 9, "degree": 16, "weights": "uniform_0_1",
         "structure_seed": 3}
FAMILIES = [(rmat, KRON), (urand, URAND)]


def _edges(mod, cfg, seed):
    return mod.generate(cfg, torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("mod,cfg", FAMILIES, ids=["rmat", "urand"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_csr_matches_build_csr(mod, cfg, seed):
    el = _edges(mod, cfg, seed)
    mine = csr.build(el.n, el.eu, el.ev, el.ew)
    ref = build_csr(el.n, el.eu.numpy(), el.ev.numpy(),
                    el.ew.numpy()).to_device("cpu")
    for field in ref._fields:
        a, b = getattr(mine, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        assert torch.equal(a, b), field


@pytest.mark.parametrize("n_edges", [1, 2, 3, 1000, 4097])
def test_csr_matches_build_csr_with_ties(n_edges):
    # few distinct weights and many repeated endpoints: the ties keep the
    # input order in both
    rng = np.random.default_rng(n_edges)
    n = 13
    eu = torch.from_numpy(rng.integers(0, n, n_edges))
    ev = torch.from_numpy((eu.numpy() + rng.integers(1, n, n_edges)) % n)
    ew = torch.from_numpy(rng.choice([0.25, 0.5, 1.0], n_edges)
                          .astype(np.float32))
    mine = csr.build(n, eu, ev, ew)
    ref = build_csr(n, eu.numpy(), ev.numpy(), ew.numpy()).to_device("cpu")
    for field in ref._fields:
        assert torch.equal(getattr(mine, field), getattr(ref, field)), field


@pytest.mark.parametrize("size", [1, 2, 5, 4095, 4096, 10_001])
@pytest.mark.parametrize("copies", [1, 2])
def test_quantile_table_is_numpys(size, copies):
    rng = np.random.default_rng(size)
    w = np.sort(rng.random(size).astype(np.float32))
    mine = csr.quantile_table(torch.from_numpy(w), copies=copies)
    full = np.repeat(w.astype(np.float64), copies)
    ref = np.quantile(full, np.linspace(0.0, 1.0, csr.RATIO_NUM))
    np.testing.assert_array_equal(mine, ref.astype(np.float32))


@pytest.mark.parametrize("mod,cfg", FAMILIES, ids=["rmat", "urand"])
def test_generators_sizes_and_seeds(mod, cfg):
    a, b, c = (_edges(mod, cfg, s) for s in (5, 5, 6))
    m = (cfg.get("edge_factor") or cfg["degree"]) << cfg["scale"]
    assert a.n == 1 << cfg["scale"] and a.eu.shape == (m,)
    assert not (a.eu == a.ev).any()
    assert a.ew.dtype == torch.float32
    assert float(a.ew.min()) > 0 and float(a.ew.max()) <= 1
    # the same seed gives the same inputs
    assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
    # another seed relabels the one weighted structure
    assert not torch.equal(a.eu, c.eu)
    assert torch.equal(a.ew, c.ew)
    deg = lambda e: torch.bincount(torch.cat([e.eu, e.ev]), minlength=e.n)
    assert torch.equal(deg(a).sort().values, deg(c).sort().values)


def test_rmat_is_skewed_and_urand_is_not():
    kron = _edges(rmat, dict(KRON, scale=12), 1)
    uni = _edges(urand, dict(URAND, scale=12), 1)
    top = lambda e: int(torch.bincount(torch.cat([e.eu, e.ev])).max())
    assert top(kron) > 10 * top(uni)
