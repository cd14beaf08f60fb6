"""The port's GNN data against the JAX package's, bitwise:
``data/synthetic.py::gnn_node_classification``,
``data/generators.py::molecule_batch`` and
``data/triplets.py::build_triplets`` (its seeded ``rng.choice`` where an
edge has more in-edges than the cap included), over seeds and caps."""
import numpy as np
import pytest

from repro.data import generators as jgen, synthetic as jsyn, triplets as jtri
from repro_torch.data import generators, synthetic, triplets
from release_xla import release_compiled  # noqa: F401


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("with_pos", [False, True])
def test_gnn_node_classification_is_the_references(seed, with_pos):
    args = (97, 300, 13, 5)
    _same(synthetic.gnn_node_classification(*args, seed=seed,
                                            with_pos=with_pos),
          jsyn.gnn_node_classification(*args, seed=seed, with_pos=with_pos))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape", [(30, 64, 4), (5, 9, 3)])
def test_molecule_batch_is_the_references(seed, shape):
    n, e, b = shape
    _same(generators.molecule_batch(n, e, b, seed=seed),
          jgen.molecule_batch(n, e, b, seed=seed))


def _hub_graph(seed):
    """Symmetrised random edges plus a hub, so that many edges have more
    in-edges than a small cap."""
    g = jsyn.gnn_node_classification(40, 120, 2, seed=seed)
    hub = np.arange(1, 25, dtype=np.int32)
    snd = np.concatenate([g["senders"], hub, np.zeros_like(hub)])
    rcv = np.concatenate([g["receivers"], np.zeros_like(hub), hub])
    return snd, rcv


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("cap", [1, 2, 8, 64])
def test_build_triplets_is_the_references(seed, cap):
    snd, rcv = _hub_graph(seed)
    got = triplets.build_triplets(snd, rcv, cap=cap, seed=seed)
    want = jtri.build_triplets(snd, rcv, cap=cap, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    kj, ji, mask = got
    assert kj.shape == (snd.shape[0] * cap,)
    # k -> j feeds j -> i with k != i
    assert np.array_equal(rcv[kj[mask]], snd[ji[mask]])
    assert not np.any(snd[kj[mask]] == rcv[ji[mask]])
    if cap <= 2:
        # the cap binds: the seeded draw ran
        assert np.bincount(ji[mask]).max() == cap


def test_build_triplets_of_no_edges():
    e = np.zeros(0, np.int32)
    for g, w in zip(triplets.build_triplets(e, e), jtri.build_triplets(e, e)):
        assert g.dtype == w.dtype and g.shape == w.shape == (0,)
