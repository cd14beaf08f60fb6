"""The paper's shortest paths as GIN features, the flow of the
reference's ``examples/gnn_sssp_features.py`` at its own size, against
the port on the CPU: ``kronecker(10, 8, seed=3)``, 8 seeded anchors
solved as one batched ``SolveSpec.tree``; the distances bitwise the
reference's and the features ``exp(-d)`` within 1e-6 (numpy's and
torch's ``exp`` may differ by an ulp); then the example's GIN (3 x 32,
8 classes, the nearest anchor as label) for 5 AdamW steps from the same
weights: each step's loss at rtol 1e-4 and the parameters within 2·lr
per step taken (the steps compound the CPU tests' one-step criteria)."""
import importlib.util
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.api import SolveSpec as JSpec, Solver as JSolver
from repro.data.generators import kronecker as jkronecker
from repro.models.gnn import gin as jgin
from repro.models.gnn.common import GraphBatch as JBatch
from repro.train import loop as jloop, optimizer as jopt
from repro_torch import convert
from repro_torch.api import SolveSpec, Solver
from repro_torch.data.generators import kronecker
from repro_torch.models.gnn import gin
from repro_torch.models.gnn.anchors import anchor_distance_features
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train import loop, optimizer as opt
from repro_torch.train.tree import leaves
from release_xla import release_compiled  # noqa: F401
from torch_gnn_common import flatten

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "gnn_sssp_features.py"
STEPS = 5


def _example():
    spec = importlib.util.spec_from_file_location("gnn_sssp_features",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_anchor_features_and_gin_steps_match_the_example():
    jg, hg = jkronecker(10, 8, seed=3), kronecker(10, 8, seed=3)
    jfeats, janchors = _example().anchor_distance_features(jg, k_anchors=8)
    feats, anchors = anchor_distance_features(hg, 8, device="cpu")
    assert np.array_equal(anchors, janchors)
    want = np.asarray(JSolver.open(jg).solve(JSpec.tree(
        [int(a) for a in anchors])).dist)
    got = Solver.open(hg, device="cpu").solve(SolveSpec.tree(
        [int(a) for a in anchors])).dist
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert feats.shape == (hg.n, 8) and feats.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), jfeats, rtol=1e-6, atol=0)

    labels = jfeats.argmax(1).astype(np.int32)
    assert np.array_equal(feats.numpy().argmax(1), labels)
    jb = JBatch(node_feat=jnp.asarray(jfeats), senders=jnp.asarray(jg.src),
                receivers=jnp.asarray(jg.dst), edge_feat=None,
                graph_ids=jnp.zeros(jg.n, jnp.int32), n_graphs=1,
                labels=jnp.asarray(labels))
    tb = GraphBatch(node_feat=feats, senders=torch.from_numpy(hg.src),
                    receivers=torch.from_numpy(hg.dst), edge_feat=None,
                    graph_ids=torch.zeros(hg.n, dtype=torch.int32),
                    labels=torch.from_numpy(labels))
    jcfg = jgin.GINConfig(d_in=8, d_hidden=32, n_layers=3, n_classes=8)
    tcfg = gin.GINConfig(d_in=8, d_hidden=32, n_layers=3, n_classes=8)
    kw = dict(lr=5e-3, warmup_steps=5, total_steps=60, master_weights=False)
    jo, to = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jp = jgin.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.gnn_params_from_reference(flatten(jp), "cpu")
    jstate, tstate = jopt.adamw_init(jp, jo), opt.adamw_init(tp, to)
    jstep = jax.jit(jloop.make_gnn_train_step(jgin.forward, jcfg, jo))
    tstep = loop.make_gnn_train_step(gin.forward, tcfg, to)
    budget = 0.0
    for i in range(STEPS):
        jp, jstate, jm = jstep(jp, jstate, jb)
        tp, tstate, tm = tstep(tp, tstate, tb)
        budget += 2 * float(tm["lr"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        for w, g in zip(jax.tree.leaves(jp), leaves(tp)):
            assert float(np.abs(np.asarray(w) - g.numpy()).max()) <= budget
