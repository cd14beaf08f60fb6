"""Shared inputs and checks of the GNN parity tests
(``tests/test_torch_gnn.py``, ``tests/test_torch_gnn_ops.py``): the
reference's and the port's config, parameters and graph batch of a
model on the same numpy arrays, and the tolerances those files state."""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.configs import get as jget
from repro.data.generators import molecule_batch
from repro.data.synthetic import gnn_node_classification
from repro.data.triplets import build_triplets
from repro.models.gnn import common as jc, dimenet as jdn, gatedgcn as jgg, \
    gin as jgin, pna as jpna
from repro.train import loop as jloop, optimizer as jopt
from repro_torch import configs, convert
from repro_torch.models.gnn import common as tc, dimenet, gatedgcn, gin, pna
from repro_torch.train import loop, optimizer as opt
from repro_torch.train.tree import leaves

ARCHS = ("gin-tu", "gatedgcn", "pna", "dimenet")
MODELS = {"gin-tu": (jgin, gin), "gatedgcn": (jgg, gatedgcn),
          "pna": (jpna, pna), "dimenet": (jdn, dimenet)}
FWD_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL_OF_SCALE = 1e-4, 1e-4
LOSS_RTOL = 1e-5
LR = 1e-3


def flatten(tree) -> dict:
    """The reference's parameter pytree as ``/``-joined numpy leaves."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                       for k in path)
        out[key] = np.asarray(leaf)
    return out


def batches(arrays: dict, n_graphs: int = 1):
    """The same arrays as a reference and a port ``GraphBatch``."""
    return (jc.GraphBatch(edge_feat=None, n_graphs=n_graphs,
                          **{k: jnp.asarray(v) for k, v in arrays.items()}),
            tc.GraphBatch(edge_feat=None, n_graphs=n_graphs,
                          **{k: torch.from_numpy(v)
                             for k, v in arrays.items()}))


def node_graph(n=60, e=150, d_in=8, n_classes=4, seed=0, cap=8):
    g = gnn_node_classification(n, e, d_in, n_classes, seed=seed,
                                with_pos=True)
    kj, ji, mk = build_triplets(g["senders"], g["receivers"], cap, seed=seed)
    return dict(g, graph_ids=np.zeros(n, np.int32), triplet_kj=kj,
                triplet_ji=ji, triplet_mask=mk)


def molecule_graphs(n=10, e=30, b=4, d_in=8, seed=0):
    """``molecule_batch`` flattened with node offsets and symmetrised, as
    the molecule cell counts it; normal features and targets."""
    mb = molecule_batch(n, e, b, seed=seed)
    off = (np.arange(b, dtype=np.int32) * n)[:, None]
    snd, rcv = (mb["senders"] + off).ravel(), (mb["receivers"] + off).ravel()
    snd, rcv = np.concatenate([snd, rcv]), np.concatenate([rcv, snd])
    rng = np.random.default_rng(seed + 100)
    kj, ji, mk = build_triplets(snd, rcv, 8, seed=seed)
    return dict(node_feat=rng.normal(0, 1, (n * b, d_in)).astype(np.float32),
                senders=snd, receivers=rcv, pos=mb["pos"].reshape(-1, 3),
                graph_ids=np.repeat(np.arange(b, dtype=np.int32), n),
                labels=rng.normal(0, 1, b).astype(np.float32),
                triplet_kj=kj, triplet_ji=ji, triplet_mask=mk), b


def cfgs(arch: str, size: str, graph_level: bool):
    """The reference's and the port's config of ``arch``: its smoke
    config or its full widths (``make_config``), node or graph level."""
    pair = []
    for get in (jget, configs.get):
        mod = get(arch)
        if size == "full":
            cfg = mod.make_config(d_in=8, n_classes=1 if graph_level else 4,
                                  graph_level=graph_level)
        else:
            cfg = mod.smoke_config()
            kw = dict(graph_level=graph_level)
            if arch == "dimenet":
                kw["n_out"] = 1 if graph_level else 4
            elif not graph_level:
                kw["n_classes"] = 4
            else:
                kw["n_classes"] = 1
            cfg = dataclasses.replace(cfg, **kw)
        pair.append(cfg)
    return pair


@functools.lru_cache(maxsize=None)
def case(arch: str, size: str, graph_level: bool):
    jcfg, tcfg = cfgs(arch, size, graph_level)
    jm, _ = MODELS[arch]
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.gnn_params_from_reference(flatten(jparams), "cpu")
    if graph_level:
        arrays, n_graphs = molecule_graphs()
    else:
        arrays, n_graphs = node_graph(), 1
    return jcfg, tcfg, jparams, tparams, batches(arrays, n_graphs)


def steps(arch, jcfg, tcfg):
    jm, tm = MODELS[arch]
    jo = jopt.AdamWConfig(lr=LR, warmup_steps=1, master_weights=False)
    to = opt.AdamWConfig(lr=LR, warmup_steps=1, master_weights=False)
    if jcfg.graph_level:
        return (jo, jloop.make_gnn_regression_step(jm.forward, jcfg, jo),
                to, loop.make_gnn_regression_step(tm.forward, tcfg, to))
    return (jo, jloop.make_gnn_train_step(jm.forward, jcfg, jo),
            to, loop.make_gnn_train_step(tm.forward, tcfg, to))


def forward_close(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= FWD_TOL * float(np.abs(want).max()), (what, err)
    return err


def grads_close(got, want):
    for path, g in zip(flatten(want), leaves(got)):
        w = flatten(want)[path]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_SCALE * float(np.abs(w).max()), err_msg=path)


def loss_fn(arch, cfg, graph_level, framework):
    """The train steps' loss of ``arch`` in either package."""
    if framework == "jax":
        fwd = MODELS[arch][0].forward

        def f(p, gb, with_out=False):
            out = fwd(cfg, p, gb)
            if graph_level:
                loss = jnp.mean((out.reshape(-1) - gb.labels.reshape(-1))
                                ** 2)
            else:
                loss = jc.node_ce_loss(out, gb.labels)
            return (loss, out) if with_out else loss
        return f
    fwd = MODELS[arch][1].forward

    def g(p, gb):
        out = fwd(cfg, p, gb)
        if graph_level:
            loss = torch.mean((out.reshape(-1) - gb.labels.reshape(-1)) ** 2)
        else:
            loss = tc.node_ce_loss(out, gb.labels)
        return loss, {"out": out}
    return g


