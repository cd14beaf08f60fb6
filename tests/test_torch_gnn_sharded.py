"""The sharded GNN ops (``repro_torch.models.gnn.sharded_ops`` with a
mesh in ``shard_ctx``) against the reference's one-device ops, over
gloo ranks in child processes, on the CPU.

``gather0``, ``scatter_sum0``, ``scatter_max0`` and ``scatter_min0`` on
DTensors split over every axis of a 1-D mesh of 2 and of 4 ranks and of
a 2-D (2, 2) mesh, forward and the gradient of ``sum(out * W)`` for a
seeded ``W``, against ``repro.models.gnn.sharded_ops``' ``ctx=None`` ops
and ``jax.grad`` on the same arrays: gather, max and min bitwise
(forward and gradient, the gradient of a gather a sum, held as the sum
below), sums within 1e-6 relative.  Four segments receive nothing, so
the max and min identities (``-inf``/``+inf``) are held too.  The plain
(per-rank tensor) form of each op gives this rank's shard of the same
result.  Then one GIN train step (smoke config) with a 4-rank
``shard_ctx`` on a (2, 2) mesh against the one-device step: the loss at
rtol 1e-5, every gradient leaf at rtol 1e-4 with a floor of 1e-4 of the
leaf's scale, and the updated parameters within 2·lr (the tolerances of
``tests/test_torch_gnn.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models.gnn import sharded_ops as jso
from repro_torch.models.gnn import common, gin
from repro_torch.train import loop, optimizer as opt
from repro_torch.train.tree import leaves
from release_xla import release_compiled  # noqa: F401
from torch_ranks_common import GNN_OPS, LR, N, gin_case, gnn_arrays, \
    shared_ranks

OPS = GNN_OPS
SUM_RTOL = 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, worker_id):
    get = lambda world, prefix: shared_ranks(world, tmp_path_factory,
                                             worker_id, prefix)
    return {2: get(2, "gnn"), 4: get(4, "gnn"), "gin": get(4, "gin")}


def _reference():
    a = {k: jnp.asarray(v) for k, v in gnn_arrays().items()}
    fns = {"gather": lambda t: jso.gather0(None, t, a["idx"]),
           "sum": lambda v: jso.scatter_sum0(None, v, a["idx"], N),
           "max": lambda v: jso.scatter_max0(None, v, a["idx"], N),
           "min": lambda v: jso.scatter_min0(None, v, a["idx"], N)}
    out = {}
    for op, fn in fns.items():
        x = a["table"] if op == "gather" else a["vals"]
        w = a["w_m"] if op == "gather" else a["w_n"]
        out[op] = np.asarray(fn(x))
        out[op + "_grad"] = np.asarray(jax.grad(
            lambda x: jnp.sum(fn(x) * w))(x))
    return out


@pytest.mark.parametrize("world,mesh", [(2, "2"), (4, "4"), (4, "2x2")])
def test_sharded_ops_match_reference(world, mesh, ranks):
    res = [{k.split("/", 1)[1]: v for k, v in r.items()
            if k.startswith(mesh + "/")} for r in ranks[world]]
    ref = _reference()
    for op in OPS:
        grad = np.concatenate([r[op + "_grad"] for r in res])
        for r in res:
            got = r[op]
            if op == "sum":
                np.testing.assert_allclose(got, ref[op], rtol=SUM_RTOL,
                                           atol=SUM_RTOL * np.abs(
                                               ref[op]).max())
            else:
                np.testing.assert_array_equal(got, ref[op])
        if op == "max":
            assert np.isneginf(ref[op][N - 4:]).all()
        if op == "min":
            assert np.isposinf(ref[op][N - 4:]).all()
        if op in ("max", "min"):
            np.testing.assert_array_equal(grad, ref[op + "_grad"])
        else:   # a gather's gradient, and a segment sum's, add rows
            np.testing.assert_allclose(grad, ref[op + "_grad"],
                                       rtol=SUM_RTOL, atol=SUM_RTOL * np.abs(
                                           ref[op + "_grad"]).max())
        rows = len(ref[op]) // world
        for rank, r in enumerate(res):
            want = ref[op][rank * rows:(rank + 1) * rows]
            np.testing.assert_allclose(r[op + "_plain"], want, rtol=SUM_RTOL,
                                       atol=SUM_RTOL * np.abs(want[
                                           np.isfinite(want)]).max())


def test_gin_step_over_four_ranks(ranks):
    res = ranks["gin"]
    cfg, g = gin_case()
    params = gin.init_params(cfg, torch.Generator().manual_seed(0))
    gb = common.GraphBatch(edge_feat=None, **{
        k: torch.from_numpy(v) for k, v in g.items()})
    ocfg = opt.AdamWConfig(lr=LR, master_weights=False, warmup_steps=0)

    def loss_fn(p, b):
        loss = common.node_ce_loss(gin.forward(cfg, p, b), b.labels)
        return loss, {"loss": loss}
    loss, _, grads = loop.value_and_grad(loss_fn, params, gb)
    new, _, _ = loop.make_gnn_train_step(gin.forward, cfg, ocfg)(
        params, opt.adamw_init(params, ocfg), gb)
    for r in res:
        np.testing.assert_allclose(r["loss"], loss.numpy(), rtol=1e-5)
        for i, want in enumerate(leaves(grads)):
            want = want.numpy()
            np.testing.assert_allclose(
                r[f"g{i}"], want, rtol=1e-4,
                atol=1e-4 * max(np.abs(want).max(), 1e-30))
        for i, want in enumerate(leaves(new)):
            np.testing.assert_allclose(r[f"p{i}"], want.numpy(), rtol=0,
                                       atol=2 * LR)
