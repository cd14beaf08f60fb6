"""Port parity: the early-exit query goals (``p2p``, ``bounded``,
``knear``) of ``repro_torch.core.sssp`` against the reference's.

The nine scale-8 benchmark graphs of ``tests/test_alt_p2p.py`` are carried
across with ``convert.from_reference``; each goal runs on both packages
from the same source with the same parameter.  ``dist``, ``parent`` (the
tentative entries included) and the logical counters must be bitwise
equal, on the port's ``segment_min`` and ``blocked`` backends and on the
fused path.
"""
import zlib

import numpy as np
import pytest
import torch

from repro.core import sssp as rsssp
from repro.core.sssp import sssp as ref_sssp
from repro_torch import convert
from repro_torch.core import sssp as tsssp
from repro_torch.core.sssp import sssp
from test_alt_p2p import benchmark_graphs, pick_pair
from test_torch_graph import ref_arrays
from test_torch_sssp import BLOCKED, _np, _port, assert_same
from release_xla import release_compiled  # noqa: F401

GRAPHS = benchmark_graphs()
PORT_BACKENDS = {"segment_min": {}, "blocked": BLOCKED,
                 "fused": dict(BLOCKED, backend="blocked", fused_rounds=4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the solves here are many tiny ops: threads only add overhead
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _goal_params(name, rg, hg):
    """The p2p target of the pair ``tests/test_alt_p2p.py`` picks for this
    graph, a bound at the 40th percentile of the source's tree distances
    and k = 12, with that pair's source."""
    s, t = pick_pair(rg, seed=zlib.crc32(name.encode()) % 1000)
    d = sssp(hg, s, device="cpu")[0].numpy()
    bound = float(np.percentile(d[np.isfinite(d)], 40))
    return s, {"p2p": t, "bounded": bound, "knear": 12}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_goals_match_reference(name):
    rg = GRAPHS[name]
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    s, params = _goal_params(name, rg, hg)
    dg = rg.to_device()
    for goal, gp in params.items():
        ref = _np(ref_sssp(dg, s, goal=goal, goal_param=gp))
        for be, opts in PORT_BACKENDS.items():
            opts = dict(opts)
            backend = opts.pop("backend", be)
            out = sssp(hg, s, backend=backend, device="cpu", goal=goal,
                       goal_param=gp, **opts)
            assert_same(ref, _port(out), f"{name} {goal}={gp} {be}")


def test_goals_stop_early_and_agree_with_the_tree():
    """A p2p answer equals the tree's at the target, a bounded one inside
    the bound, a knear one on the k + 1 nearest; none takes more steps."""
    rg = GRAPHS["gr_8"]
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    s, params = _goal_params("gr_8", rg, hg)
    d, p, m = sssp(hg, s, device="cpu")
    tree_steps = int(m.n_steps)
    for goal, gp in params.items():
        dq, pq, mq = sssp(hg, s, device="cpu", goal=goal, goal_param=gp)
        assert int(mq.n_steps) <= tree_steps, goal
        if goal == "knear":
            near = lambda x: torch.sort(x).values[:gp + 1]
            assert torch.equal(near(dq), near(d)), goal
            continue
        keep = (d <= gp) if goal == "bounded" else \
            (torch.arange(d.numel()) == gp)
        assert torch.equal(dq[keep], d[keep]) and torch.equal(pq[keep],
                                                              p[keep]), goal


@pytest.mark.parametrize("goal,params", [
    ("tree", None), ("tree", np.arange(3)), ("p2p", 7), ("p2p", [1, 2]),
    ("bounded", 2), ("bounded", [0.5, 1.25]), ("knear", 12)])
def test_goal_param_array_matches_reference(goal, params):
    want = np.asarray(rsssp.goal_param_array(goal, params))
    got = tsssp.goal_param_array(goal, params)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("goal,params,match", [
    ("nearest", 3, "unknown goal"), ("p2p", None, "requires a parameter"),
    ("bounded", None, "requires a parameter")])
def test_goal_param_array_errors(goal, params, match):
    for mod in (rsssp, tsssp):
        with pytest.raises(ValueError, match=match):
            mod.goal_param_array(goal, params)


@pytest.mark.parametrize("target", [-1, 256, 10_000])
def test_p2p_target_out_of_range_raises(target):
    rg = GRAPHS["gr_4"]
    hg = convert.from_reference(ref_arrays(rg), "cpu")
    with pytest.raises(ValueError, match="out of range"):
        ref_sssp(rg.to_device(), 0, goal="p2p", goal_param=target)
    with pytest.raises(ValueError, match="out of range"):
        sssp(hg, 0, device="cpu", goal="p2p", goal_param=target)
    # other goals take any parameter: a bound or k is never an index
    tsssp._check_goal_bounds("knear", tsssp.goal_param_array(
        "knear", target), hg.n)
