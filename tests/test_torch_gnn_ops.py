"""The port's GNN segment ops and model paths against the JAX package,
on the CPU, beyond ``tests/test_torch_gnn.py``'s parity cases:
``seg_*`` against ``jax.ops.segment_*`` (sums at rtol 1e-6; max, min and
empty segments exactly) and the tie gradient of the segment max and min
(both packages split it evenly); PNA on a graph with isolated nodes and
tied maxima, and its graph-level overflow there (reference fault 5);
remat on and off (bitwise); DimeNet's triplet chunks against one chunk
and the reference; edge-mask padding; a sharded context (plain tensors
are a rank's shards: on a one-rank mesh the ops give the one-device
result; a context without a mesh refused); graph batches, the train-step builders' inputs and the parameter conversion.
Tolerances are ``torch_gnn_common``'s (the forward within 1e-4 of its
largest magnitude, gradients at rtol 1e-4 with a floor of 1e-4 of the
leaf's scale)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get as jget
from repro.models.gnn import common as jc, dimenet as jdn, gin as jgin, \
    pna as jpna
from repro.train import optimizer as jopt
from repro_torch import configs, convert
from repro_torch.models.gnn import common as tc, dimenet, gin
from repro_torch.models.gnn.sharded_ops import gather0, scatter_sum0
from repro_torch.train import loop, optimizer as opt
from repro_torch.train.tree import leaves
from release_xla import release_compiled  # noqa: F401
from torch_gnn_common import (ARCHS, LOSS_RTOL, MODELS, batches, case, cfgs,
                              flatten, forward_close, grads_close, loss_fn,
                              molecule_graphs, node_graph, steps)


# --- segment ops -------------------------------------------------------------

SEG_IDS = np.array([0, 0, 2, 2, 2, 4, 0, 5], np.int32)     # 1 and 3 empty


def _seg_inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (8, 3)).astype(np.float32)
    x[1] = x[0]                                # a tie in segment 0
    return x


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "softmax"])
def test_segment_ops_match_jax(op):
    x, n = _seg_inputs(), 6
    tx, ids = torch.from_numpy(x), torch.from_numpy(SEG_IDS)
    want = np.asarray(getattr(jc, f"seg_{op}")(jnp.asarray(x),
                                                jnp.asarray(SEG_IDS), n))
    got = getattr(tc, f"seg_{op}")(tx, ids, n).numpy()
    if op in ("max", "min"):
        # exact, the empty segments' identity (-inf / +inf) included
        assert np.array_equal(got, want)
        assert np.all(np.isinf(got[[1, 3]]))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # a 1-D input, shaped as the reference shapes it (seg_mean's [n, 1]
    # count broadcasts a 1-D sum to [n, n] in both)
    got1 = getattr(tc, f"seg_{op}")(tx[:, 0], ids, n).numpy()
    want1 = np.asarray(getattr(jc, f"seg_{op}")(jnp.asarray(x[:, 0]),
                                                jnp.asarray(SEG_IDS), n))
    assert got1.shape == want1.shape
    np.testing.assert_allclose(got1, want1, rtol=1e-6, atol=1e-7)


def test_in_degree_with_mask_matches_jax():
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    for m in (None, mask):
        want = jc.in_degree(jnp.asarray(SEG_IDS), 6,
                            None if m is None else jnp.asarray(m))
        got = tc.in_degree(torch.from_numpy(SEG_IDS), 6,
                           None if m is None else torch.from_numpy(m))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["max", "min"])
def test_segment_extreme_splits_a_tie_gradient_evenly(op):
    """Where several entries tie at a segment's max (min), JAX and torch
    both give each the same share of the gradient."""
    x = np.array([[1., 2.], [1., 5.], [0., 5.], [3., 3.]], np.float32)
    if op == "min":
        x = -x
    ids = np.array([0, 0, 0, 2], np.int32)
    rows = np.array([0, 2])
    want = np.asarray(jax.grad(lambda v: (getattr(jc, f"seg_{op}")(
        v, jnp.asarray(ids), 3)[rows]).sum())(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    getattr(tc, f"seg_{op}")(tx, torch.from_numpy(ids), 3)[[0, 2]].sum() \
        .backward()
    assert np.array_equal(tx.grad.numpy(), want)
    assert np.array_equal(want, [[0.5, 0], [0.5, 0.5], [0, 0.5], [1, 1]])


# --- PNA: isolated nodes and ties -------------------------------------------

def _isolated_and_tied(n_iso=3, n_dup=20):
    """The 60-node graph with ``n_iso`` isolated nodes appended and
    ``n_dup`` edges repeated (identical messages: ties at the max)."""
    g = node_graph()
    n = g["node_feat"].shape[0]
    rng = np.random.default_rng(9)
    feat = np.concatenate([g["node_feat"], rng.normal(
        0, 1, (n_iso, g["node_feat"].shape[1])).astype(np.float32)])
    snd = np.concatenate([g["senders"], g["senders"][:n_dup]])
    rcv = np.concatenate([g["receivers"], g["receivers"][:n_dup]])
    labels = np.concatenate([g["labels"], np.zeros(n_iso, np.int32)])
    return dict(node_feat=feat, senders=snd, receivers=rcv, labels=labels,
                graph_ids=np.zeros(n + n_iso, np.int32))


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_pna_isolated_nodes_and_ties_match_reference(size):
    jcfg, tcfg = cfgs("pna", size, False)
    jp = jpna.init_params(jcfg, jax.random.PRNGKey(1))
    tp = convert.gnn_params_from_reference(flatten(jp), "cpu")
    jb, tb = batches(_isolated_and_tied())
    jf = loss_fn("pna", jcfg, False, "jax")
    (jloss, want), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jf(p, b, with_out=True), has_aux=True))(jp, jb)
    tloss, tmet, tgrads = loop.value_and_grad(
        loss_fn("pna", tcfg, False, "torch"), tp, tb)
    got = tmet["out"]
    forward_close(got, want, "pna isolated")
    # an isolated node's empty max/min segments are clipped to -+3e30 and
    # scaled by the attenuation 2/1e-6: its logits are of order 1e33
    assert float(got[-3:].abs().max()) > 1e30
    assert float(got[:-3].abs().max()) < 1e30
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    grads_close(tgrads, jgrads)


def test_pna_regression_overflows_on_isolated_nodes_as_the_reference():
    """Reference fault 5 (ROADMAP.md, queue 3): at the molecule shape's
    density some nodes are isolated; PNA's clipped empty max/min times
    the attenuation scaler reaches the pooled prediction, the squared
    error overflows, the clipped update multiplies an inf gradient by 0,
    and NaN lands in the same parameter leaves in both packages."""
    arrays, b = molecule_graphs(30, 64, 8, d_in=16)
    assert np.bincount(arrays["receivers"], minlength=240).min() == 0
    jcfg, tcfg = cfgs("pna", "smoke", True)
    jcfg = dataclasses.replace(jcfg, d_in=16)
    tcfg = dataclasses.replace(tcfg, d_in=16)
    jp = jpna.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.gnn_params_from_reference(flatten(jp), "cpu")
    jb, tb = batches(arrays, b)
    jo, jstep, to, tstep = steps("pna", jcfg, tcfg)
    jp2, _, jm = jax.jit(jstep)(jp, jopt.adamw_init(jp, jo), jb)
    tp2, _, tm = tstep(tp, opt.adamw_init(tp, to), tb)
    assert np.isinf(float(jm["loss"])) and np.isinf(float(tm["loss"]))
    assert np.isinf(float(jm["grad_norm"]))
    assert np.isinf(float(tm["grad_norm"]))
    jnan = [bool(np.isnan(np.asarray(w)).any()) for w in jax.tree.leaves(jp2)]
    tnan = [bool(torch.isnan(g).any()) for g in leaves(tp2)]
    assert any(jnan) and tnan == jnan


# --- remat, triplet chunks, edge padding ------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_outputs_and_gradients(arch):
    _, tcfg, _, tp, (_, tb) = case(arch, "smoke", arch == "dimenet")
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss, _, grads = loop.value_and_grad(
            loss_fn(arch, cfg, arch == "dimenet", "torch"), tp, tb)
        out[remat] = (loss, leaves(grads))
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                 out[True][1]))


def test_dimenet_triplet_chunks_match_one_chunk_and_reference():
    jcfg, tcfg, jp, tp, (jb, tb) = case("dimenet", "smoke", False)
    t = tb.triplet_kj.shape[0]
    assert t % 4 == 0
    one = dimenet.forward(tcfg, tp, tb)
    loss1, _, g1 = loop.value_and_grad(
        loss_fn("dimenet", tcfg, False, "torch"), tp, tb)
    c4 = dataclasses.replace(tcfg, triplet_chunks=4)
    four = dimenet.forward(c4, tp, tb)
    np.testing.assert_allclose(four.detach().numpy(), one.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    loss4, _, g4 = loop.value_and_grad(
        loss_fn("dimenet", c4, False, "torch"), tp, tb)
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=1e-6)
    for a, b in zip(leaves(g4), leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(b.abs().max()))
    j4 = dataclasses.replace(jcfg, triplet_chunks=4)
    forward_close(four, jax.jit(lambda p, b: jdn.forward(j4, p, b))(jp, jb),
                  "dimenet chunked")


@pytest.mark.parametrize("arch", ["gin-tu", "gatedgcn", "pna"])
def test_edge_mask_padding(arch):
    """Padding edges (sender = receiver = 0, masked out) change nothing:
    the padded forward equals the unpadded one, and the reference's
    padded forward."""
    jcfg, tcfg, jp, tp, (_, tb) = case(arch, "smoke", False)
    arrays = node_graph()
    pad = 13
    e = arrays["senders"].shape[0]
    padded = dict(arrays, senders=np.concatenate(
        [arrays["senders"], np.zeros(pad, np.int32)]),
        receivers=np.concatenate([arrays["receivers"],
                                  np.zeros(pad, np.int32)]),
        edge_mask=np.arange(e + pad) < e)
    jpb, tpb = batches(padded)
    jm, tm = MODELS[arch]
    got = tm.forward(tcfg, tp, tpb)
    np.testing.assert_allclose(got.detach().numpy(),
                               tm.forward(tcfg, tp, tb).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    forward_close(got, jax.jit(lambda p, b: jm.forward(jcfg, p, b))(jp, jpb),
                  arch + " padded")


# --- one device only, batches, conversion ------------------------------------

def test_a_sharded_context_raises(tmp_path):
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    tb = case("gin-tu", "smoke", False)[-1][1]
    sharded = tb._replace(shard_ctx=("mesh", ("x",)))
    # a plain tensor is this rank's shard: nothing to constrain
    assert tc.shard0(sharded, tb.node_feat) is tb.node_feat
    with pytest.raises(TypeError, match="DeviceMesh"):
        gather0(("mesh", ("x",)), tb.node_feat, tb.senders)
    with pytest.raises(TypeError, match="DeviceMesh"):
        scatter_sum0(("mesh", ("x",)), tb.node_feat, tb.senders, 60)
    assert tc.shard0(tb, tb.node_feat) is tb.node_feat
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        ctx = (init_device_mesh("cpu", (1,), mesh_dim_names=("x",)), ("x",))
        senders = tb.senders.long()
        assert torch.equal(gather0(ctx, tb.node_feat, senders),
                           gather0(None, tb.node_feat, senders))
        msg = tb.node_feat.index_select(0, senders)
        torch.testing.assert_close(scatter_sum0(ctx, msg, senders, 60),
                                   scatter_sum0(None, msg, senders, 60),
                                   rtol=1e-6, atol=1e-6)
    finally:
        tdist.destroy_process_group()


def test_graph_batch_moves_its_arrays():
    arrays = node_graph()
    gb = tc.GraphBatch(edge_feat=None, **arrays).to("cpu")
    assert isinstance(gb.senders, torch.Tensor)
    assert gb.senders.dtype == torch.int32 and gb.n_graphs == 1
    assert gb.edge_feat is None and gb.shard_ctx is None
    tcfg = configs.get("gin-tu").smoke_config()
    tcfg = dataclasses.replace(tcfg, n_classes=4)
    params = gin.init_params(tcfg, torch.Generator().manual_seed(0))
    ocfg = opt.AdamWConfig(master_weights=False)
    # numpy fields go to the parameters' device in the step
    step = loop.make_gnn_train_step(gin.forward, tcfg, ocfg, microbatches=4)
    _, state, m = step(params, opt.adamw_init(params, ocfg),
                       tc.GraphBatch(edge_feat=None, **arrays))
    assert torch.isfinite(m["loss"]) and int(state["step"]) == 1


def test_gnn_params_from_reference_keeps_the_tree():
    jp = jgin.init_params(jget("gin-tu").smoke_config(), jax.random.PRNGKey(0))
    flat = flatten(jp)
    assert "layers/mlp/w/1" in flat and "head/b/0" in flat
    tp = convert.gnn_params_from_reference(flat, "cpu")
    assert isinstance(tp["layers"]["mlp"]["w"], list)
    assert tp["layers"]["mlp"]["w"][0].shape == (1, 16, 16)
    with pytest.raises(ValueError, match="gaps"):
        convert.gnn_params_from_reference({"head/w/1": flat["head/w/0"]},
                                          "cpu")
    with pytest.raises(TypeError):
        convert.gnn_params_from_reference(flat)        # a device is needed


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_references_tree(arch):
    tcfg = configs.get(arch).make_config(d_in=12, n_classes=3)
    jcfg = jget(arch).make_config(d_in=12, n_classes=3)
    tp = MODELS[arch][1].init_params(tcfg, torch.Generator().manual_seed(0))
    jshape = jax.eval_shape(lambda k: MODELS[arch][0].init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jshape)).items()}
    got = convert.gnn_params_from_reference(
        {k: np.zeros(v) for k, v in want.items()}, "cpu")
    assert [tuple(t.shape) for t in leaves(tp)] == \
        [tuple(t.shape) for t in leaves(got)]
    assert all(t.dtype == torch.float32 for t in leaves(tp))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_exits_for_gnn_archs(arch, tmp_path):
    """As the reference's ``launch/train.py``: GNN training goes through
    the anchor-feature example, not the launcher."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="gnn_sssp_features"):
        train.main(["--arch", arch, "--steps", "1", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
