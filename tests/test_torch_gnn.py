"""The port's GNN models (GIN, GatedGCN, PNA, DimeNet) and their train
steps against the JAX package, on the CPU.

Inputs are the same numpy arrays (the data functions' own, which
``tests/test_torch_gnn_data.py`` holds bitwise), parameters the
reference's ``init_params`` carried over by
``convert.gnn_params_from_reference``.  Each model at its smoke config
and once at full width (the configs' ``make_config``) on a 60-node
graph, node level with cross entropy and graph level (a batch of small
graphs, dense enough that no node is isolated) with the regression
step: the forward, the gradients of the loss and one AdamW update from
them; and one step of each train-step builder (the reference's jitted
step against the port's).  The full widths are in
``tests/test_torch_gnn_full.py``.  PNA on graphs with
isolated nodes and tied maxima has tests of its own: there its graph
level regression overflows in both packages (ROADMAP.md, queue 3,
reference fault 5).

Tolerances (``torch_gnn_common``), with the largest error measured on
this CPU over these cases and the full widths beside each: the forward
within 1e-4 of its largest magnitude (7.0e-5, PNA at the smoke widths:
its ``std`` is ``sqrt`` of a variance that rounds near 0 on a node with
one neighbour; 4.8e-7 for the other models); the loss at rtol 1e-5
(4.4e-7); every gradient leaf at rtol 1e-4 with an absolute floor of
1e-4 of the leaf's largest magnitude (PNA at full width reaches 0.73 of
that allowance, 9.9e-5 of its scale; the other models 0.012); after one
AdamW update, the parameters within 2·lr, the CPU tests' criterion of
the LM steps (1.31e-3 of 2e-3, PNA at full width: Adam's first step is
±lr a component, and a near-zero gradient component flipped its sign;
the other models 4.8e-5).
"""
import numpy as np
import pytest

import jax
from repro.train import optimizer as jopt
from repro_torch.train import loop, optimizer as opt
from repro_torch.train.tree import leaves
from release_xla import release_compiled  # noqa: F401
from torch_gnn_common import (ARCHS, LOSS_RTOL, LR, case, forward_close,
                              grads_close, loss_fn, steps)

@pytest.mark.parametrize("graph_level", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_gradients_and_step_match_reference(arch, graph_level):
    check_case(arch, "smoke", graph_level)


def check_case(arch, size, graph_level, inputs=None):
    """Forward, loss, gradients and one AdamW update of ``arch`` at
    ``size`` (or on ``inputs``, a :func:`torch_gnn_common.case` tuple)
    against the reference; returns the largest errors measured."""
    jcfg, tcfg, jp, tp, (jb, tb) = inputs or case(arch, size, graph_level)
    jf = loss_fn(arch, jcfg, graph_level, "jax")
    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jf(p, b, with_out=True), has_aux=True))(jp, jb)
    tloss, tmet, tgrads = loop.value_and_grad(
        loss_fn(arch, tcfg, graph_level, "torch"), tp, tb)
    fwd_err = forward_close(tmet["out"], jout, arch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    grads_close(tgrads, jgrads)
    # one AdamW update from those gradients
    jo = jopt.AdamWConfig(lr=LR, warmup_steps=1, master_weights=False)
    to = opt.AdamWConfig(lr=LR, warmup_steps=1, master_weights=False)
    jp2, _, jm = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jo))(
        jp, jgrads, jopt.adamw_init(jp, jo))
    tp2, to2, tm = opt.adamw_update(tp, tgrads, opt.adamw_init(tp, to), to)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    gap = max(float(np.abs(np.asarray(w) - g.numpy()).max())
              for w, g in zip(jax.tree.leaves(jp2), leaves(tp2)))
    assert gap <= 2 * LR
    assert int(to2["step"]) == 1
    return dict(forward=fwd_err / float(np.abs(np.asarray(jout)).max()),
                loss=abs(float(tloss) - float(jloss)) / abs(float(jloss)),
                param_gap=gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """``make_gnn_train_step`` (node level) and, for DimeNet,
    ``make_gnn_regression_step`` (its smoke config is graph level): one
    step of the reference's jitted builder against the port's."""
    gl = arch == "dimenet"
    jcfg, tcfg, jp, tp, (jb, tb) = case(arch, "smoke", gl)
    jo, jstep, to, tstep = steps(arch, jcfg, tcfg)
    jp2, _, jm = jax.jit(jstep)(jp, jopt.adamw_init(jp, jo), jb)
    tp2, to2, tm = tstep(tp, opt.adamw_init(tp, to), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for w, g in zip(jax.tree.leaves(jp2), leaves(tp2)):
        assert float(np.abs(np.asarray(w) - g.numpy()).max()) <= 2 * LR
    assert int(to2["step"]) == 1


