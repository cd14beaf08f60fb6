"""The sampled GNN cell (``minibatch_lg``) on the CPU against the JAX
package.

``tools/gnn_phase.py::sampled_batch`` builds one step's padded subgraph
(the port's ``NeighborSampler`` and ``flat_subgraph``, rows gathered by
node id, DimeNet's triplets over the real edges); ``chip_smoke.py``
phase 4e-d trains on it at full width.  Here, on a seeded 500-node graph
with fanouts (15, 10) and 32 seeds (the cell's pads scaled to them:
5,664 nodes, 5,760 edges, 11,520 triplet slots), the batch must be
bitwise the one the reference's sampler, ``flat_subgraph`` and
``build_triplets`` give, and each model at its smoke config, with the
cell's remat (and DimeNet's 4 triplet chunks), must match the reference
in the forward, the gradients and one AdamW update, to the tolerances
of ``tests/test_torch_gnn.py`` (``torch_gnn_common``).  Largest errors
measured on this CPU over GIN, GatedGCN and DimeNet: the forward 2.2e-7
of its scale (tolerance 1e-4), the loss 6.0e-7 relative (rtol 1e-5),
the parameters 1.5e-7 after the update (budget 2·lr = 2e-3).  PNA's
output overflows to NaN on a sampled subgraph in both packages (its own
test below).
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from repro.data.sampler import NeighborSampler as RefSampler
from repro.data.sampler import flat_subgraph as ref_flat_subgraph
from repro.data.synthetic import gnn_node_classification
from repro.data.triplets import build_triplets as ref_build_triplets
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.data.sampler import NeighborSampler
from repro_torch.train import loop, optimizer as opt
from repro_torch.train.tree import leaves
from release_xla import release_compiled  # noqa: F401
from test_torch_gnn import check_case
from torch_gnn_common import (ARCHS, FWD_TOL, LR, MODELS, batches, cfgs,
                              flatten, loss_fn)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import gnn_phase  # noqa: E402

N, E, D_IN, N_CLASSES, SEEDS = 500, 2000, 8, 4, 32
FANOUTS = (15, 10)
ERRORS = {}


@functools.lru_cache(maxsize=None)
def graph():
    g = gnn_node_classification(N, E, D_IN, N_CLASSES, seed=0, with_pos=True)
    row_ptr, col = gnn_phase.csr_by_receiver(g["senders"], g["receivers"],
                                             N, "cpu")
    seeds = np.random.default_rng(0).choice(N, SEEDS, replace=False)
    return g, row_ptr, col, seeds


@functools.lru_cache(maxsize=None)
def port_batch():
    g, row_ptr, col, seeds = graph()
    data = {k: torch.from_numpy(g[k]) for k in ("node_feat", "labels", "pos")}
    sampler = NeighborSampler(row_ptr, col, FANOUTS, seed=0)
    return gnn_phase.sampled_batch(data, sampler, seeds, "cpu")


def reference_arrays():
    """The same step from the reference's modules and numpy gathers."""
    g, row_ptr, col, seeds = graph()
    pad_n, pad_e, pad_t = gnn_phase.cell_pads(SEEDS)
    sample = RefSampler(row_ptr, col, FANOUTS, seed=0).sample(seeds)
    snd, rcv, emask, ids, _ = ref_flat_subgraph(sample, pad_n, pad_e)
    e = int(emask.sum())
    kj, ji, tm = ref_build_triplets(snd[:e], rcv[:e], 2, seed=0)
    pad = pad_t - kj.shape[0]
    return dict(node_feat=g["node_feat"][ids], senders=snd, receivers=rcv,
                graph_ids=np.zeros(pad_n, np.int32), labels=g["labels"][ids],
                pos=g["pos"][ids], edge_mask=emask,
                triplet_kj=np.concatenate([kj, np.zeros(pad, np.int32)]),
                triplet_ji=np.concatenate([ji, np.zeros(pad, np.int32)]),
                triplet_mask=np.concatenate([tm, np.zeros(pad, bool)]))


def test_sampled_batch_is_the_references_bitwise():
    gb, info = port_batch()
    want = reference_arrays()
    for key, arr in want.items():
        got = getattr(gb, key).numpy()
        assert got.dtype == arr.dtype, key
        assert got.shape == arr.shape, key
        assert np.array_equal(got.view(np.uint8), arr.view(np.uint8)), key
    assert (info["pad_nodes"], info["pad_edges"], info["pad_triplets"]) == \
        (SEEDS * 177, SEEDS * 180, SEEDS * 360)
    # the sample fills most of the edge pad and all 500 nodes fit
    assert info["edges"] == int(want["edge_mask"].sum()) > SEEDS * 15
    assert info["nodes"] <= N
    assert 0 < info["triplets"] <= info["pad_triplets"]


def test_cell_pads_are_minibatch_lg_at_1024_seeds():
    assert gnn_phase.cell_pads(1024) == (181248, 184320, 368640)


def cell_case(arch):
    """The reference's and the port's smoke config with the cell's remat
    (and DimeNet's 4 triplet chunks), the same weights, and the sampled
    batch in both packages."""
    jcfg, tcfg = cfgs(arch, "smoke", False)
    kw = dict(remat=True)
    if arch == "dimenet":
        kw["triplet_chunks"] = 4
    jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    jp = MODELS[arch][0].init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.gnn_params_from_reference(flatten(jp), "cpu")
    arrays = {k: v.numpy() for k, v in vars(port_batch()[0]).items()
              if isinstance(v, torch.Tensor)}
    return jcfg, tcfg, jp, tp, batches(arrays)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "pna"])
def test_sampled_cell_step_matches_reference(arch):
    ERRORS[arch] = check_case(arch, None, False, inputs=cell_case(arch))


def _same_where_finite(got, want, what):
    """NaN and inf at the same entries; the finite ones within 1e-4 of
    their largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    assert np.array_equal(np.isinf(got), np.isinf(want)), what
    keep = np.isfinite(want)
    if keep.any():
        err = float(np.abs(got[keep] - want[keep]).max())
        assert err <= FWD_TOL * float(np.abs(want[keep]).max()), (what, err)


def test_sampled_pna_overflows_to_nan_in_both_packages():
    """PNA at node level on a sampled subgraph: the innermost sampled
    nodes have no in-edges, their empty max/min segments are clipped to
    +-3e30 and scaled by the attenuation (reference fault 5, ROADMAP
    queue 3), and their neighbours' sums overflow to NaN.  Both packages
    give NaN at the same outputs (the finite ones agree), a NaN loss, and
    after the AdamW update every parameter NaN.  The gradients are NaN
    wherever the reference's are, and in more entries: torch's backward
    carries the NaN rows into the first layer's weights, where XLA's
    leaves them finite (layer0/w_post: all 1,824 entries NaN against
    none); where both are finite they agree."""
    jcfg, tcfg, jp, tp, (jb, tb) = cell_case("pna")
    jf = loss_fn("pna", jcfg, False, "jax")
    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jf(p, b, with_out=True), has_aux=True))(jp, jb)
    tloss, tmet, tgrads = loop.value_and_grad(
        loss_fn("pna", tcfg, False, "torch"), tp, tb)
    out = tmet["out"].detach().numpy()
    assert np.isnan(out).any() and np.isfinite(out).any()
    _same_where_finite(out, jout, "forward")
    assert np.isnan(float(jloss)) and np.isnan(float(tloss))
    for (path, w), g in zip(flatten(jgrads).items(), leaves(tgrads)):
        g = g.numpy()
        assert not np.isinf(g).any() and not np.isinf(w).any(), path
        assert np.isnan(g[np.isnan(w)]).all(), path
        both = np.isfinite(g) & np.isfinite(w)
        if both.any():
            np.testing.assert_allclose(g[both], w[both], rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w[both]).max()),
                                       err_msg=path)
    jo = jopt.AdamWConfig(lr=LR, warmup_steps=1, master_weights=False)
    to = opt.AdamWConfig(lr=LR, warmup_steps=1, master_weights=False)
    jp2, _, _ = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jo))(
        jp, jgrads, jopt.adamw_init(jp, jo))
    tp2, _, _ = opt.adamw_update(tp, tgrads, opt.adamw_init(tp, to), to)
    for w, g in zip(jax.tree.leaves(jp2), leaves(tp2)):
        assert np.isnan(np.asarray(w)).all() and torch.isnan(g).all()
