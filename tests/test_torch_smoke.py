"""``chip_smoke.py``'s checks that need no card.

A profiled pass (``lm_profile``, ``recsys_profile``) reads the device time
by kernel from ``torch.profiler``.  A trace that recorded no CUDA kernel
once passed as 0 device ms; ``chip_smoke.trace_kernels`` now fails such a
pass, naming it.  Here a real CPU-only trace (which holds no CUDA kernel)
must fail, and a trace with CUDA entries must give exactly those.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import chip_smoke  # noqa: E402


def test_profiled_pass_without_a_kernel_fails():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64).cumsum(0)
    events = prof.key_averages()
    assert len(events) > 0               # the pass was traced, on the host
    with pytest.raises(AssertionError,
                       match="recsys_profile retrieval_scores: .*no CUDA"):
        chip_smoke.trace_kernels(events, "recsys_profile retrieval_scores")


def test_trace_kernels_gives_the_cuda_entries():
    event = lambda key, kind: SimpleNamespace(key=key, device_type=kind)
    events = [event("aten::mm", DeviceType.CPU),
              event("bag_kernel", DeviceType.CUDA),
              event("cudaLaunchKernel", DeviceType.CPU),
              event("flash_fwd_tc", DeviceType.CUDA)]
    kern = chip_smoke.trace_kernels(events, "lm_profile prefill")
    assert [e.key for e in kern] == ["bag_kernel", "flash_fwd_tc"]
    with pytest.raises(AssertionError, match="lm_profile decode"):
        chip_smoke.trace_kernels(events[::2], "lm_profile decode")


def test_adaptive_parents_may_differ_only_at_exact_ties():
    """Phase 3c holds an adaptive solve to the static one: dist bitwise,
    parents equal but where both are exact f32 ties.  On a square with
    two equal paths to vertex 3 either parent passes; a parent that is
    no shortest-path edge, or another dist, fails."""
    from repro_torch.core.graph import build_csr
    hg = build_csr(4, [0, 0, 1, 2], [1, 2, 3, 3], [1.0, 1.0, 1.0, 1.0])
    dist = torch.tensor([0.0, 1.0, 1.0, 2.0])
    static = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    ties = chip_smoke.same_tree_up_to_ties(
        hg, dist, torch.tensor([0, 0, 0, 2], dtype=torch.int32), dist,
        static, None, "square")
    assert ties == 1
    with pytest.raises(AssertionError, match="not a shortest-path edge"):
        chip_smoke.same_tree_up_to_ties(
            hg, dist, torch.tensor([0, 0, 0, 0], dtype=torch.int32), dist,
            static, None, "square")
    with pytest.raises(AssertionError, match="dist differs"):
        chip_smoke.same_tree_up_to_ties(
            hg, dist + torch.tensor([0, 0, 0, 1.0]), static, dist, static,
            None, "square")
    keep = dist <= 1.0                  # a bounded query's settled entries
    assert chip_smoke.same_tree_up_to_ties(
        hg, dist, torch.tensor([0, 0, 0, 0], dtype=torch.int32), dist,
        static, keep, "square bounded") == 0


@pytest.mark.parametrize("shape,nodes,edges,slots,graphs", [
    ("full_graph_sm", 2708, 21112, 168896, 1),
    ("molecule", 3840, 16384, 131072, 128)])
def test_gnn_cells_have_the_shapes_the_cells_count(shape, nodes, edges, slots,
                                                   graphs):
    arrays, n_graphs, graph_level = chip_smoke.gnn_cell_batch(shape)
    assert arrays["node_feat"].shape[0] == nodes
    assert arrays["senders"].shape == arrays["receivers"].shape == (edges,)
    assert arrays["triplet_kj"].shape == (slots,)
    assert n_graphs == graphs and graph_level == (shape == "molecule")
    assert arrays["graph_ids"].max() == graphs - 1
    assert not np.any(arrays["senders"] == arrays["receivers"])


def test_a_card_step_is_held_to_the_cpu_step():
    p = {"w": torch.ones(3)}
    cpu = ({"w": torch.ones(3)}, {"loss": 2.0, "lr": 1e-3})
    row = chip_smoke.same_step((p, {"loss": 2.0}), cpu, "same")
    assert row["max_param_gap"] == 0.0 and not row["fault5"]
    with pytest.raises(AssertionError, match="differs"):
        chip_smoke.same_step(({"w": torch.ones(3) + 0.01}, {"loss": 2.0}),
                             cpu, "moved")
    with pytest.raises(AssertionError, match="differs"):
        chip_smoke.same_step((p, {"loss": 2.1}), cpu, "loss")
    # a step the CPU also overflows: the same non-finite loss and NaN leaves
    nan = {"w": torch.tensor([1.0, float("nan"), 1.0])}
    over = (nan, {"loss": float("inf"), "lr": 1e-3})
    assert chip_smoke.same_step(
        ({"w": torch.tensor([1.0, float("nan"), 1.0])},
         {"loss": float("inf")}), over, "fault 5")["fault5"]
    with pytest.raises(AssertionError, match="differs"):
        chip_smoke.same_step((p, {"loss": float("inf")}), over, "nan moved")


def _fault1_case():
    """The reference property test's seed 3679 (ROADMAP queue 3, fault
    1), built with the port: its EIC tree, Bellman-Ford's and the EIC
    solve's window edges."""
    import tooling_phase
    from repro_torch.core.baselines import bellman_ford
    from repro_torch.core.graph import build_csr
    from repro_torch.core.sssp import sssp
    rng = np.random.default_rng(3679)
    n = int(rng.integers(20, 150))
    m = int(rng.integers(n, 6 * n))
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = u != v
    w = rng.random(keep.sum()) * float(rng.uniform(0.5, 10)) + 1e-3
    hg = build_csr(n, u[keep], v[keep], w)
    nz = np.where(hg.deg > 0)[0]
    src = int(nz[rng.integers(0, nz.size)])
    dg = hg.to_device("cpu")
    d, p, m = sssp(dg, src, backend="blocked", device="cpu")
    bd, bp, _ = bellman_ford(dg, src)
    lbs = tooling_phase.window_edges(dg, src, int(m.n_host_syncs), "cpu")
    return hg, dg, src, (d, p, m), (bd, bp), lbs


def test_phase_4e_names_reference_fault_1_and_fails_anything_else():
    """Phase 4e holds an exact solver's dist bitwise to EIC's but at
    vertices shown to be reference fault 1: on seed 3679 vertex 75 is the
    dropped candidate (its exact parent 33 is right, the candidate equals
    a window's lower edge, and the push band under it starts above 33)
    and 39, 41, 49 lie below it.  A vertex EIC has shorter, or one whose
    candidate no window dropped, fails the phase."""
    import tooling_phase
    hg, _, _, (d, _, _), (bd, bp), lbs = _fault1_case()
    got = tooling_phase.explain_fault1(hg, d.numpy(), bd.numpy(), bp.numpy(),
                                       lbs, "seed 3679")
    assert got == dict(roots=[75], downstream=[49, 39, 41])
    with pytest.raises(AssertionError, match="other than by reference fault"):
        tooling_phase.explain_fault1(hg, d.numpy(), bd.numpy(), bp.numpy(),
                                     lbs[:0], "seed 3679 without windows")
    short = d.numpy().copy()
    short[int(np.flatnonzero(np.isfinite(short) & (short > 0))[0])] -= 0.25
    with pytest.raises(AssertionError, match="other than by reference fault"):
        tooling_phase.explain_fault1(hg, short, bd.numpy(), bp.numpy(), lbs,
                                     "seed 3679 shortened")


def test_phase_4e_check_against_the_tree_fails_the_smoke():
    """``against_tree`` (4e-a and 4e-b) raises on a tree that disagrees
    with the exact solver, and on a parent tree that is not tight; the
    smoke's ``main`` calls phase 4e outside any ``try``, so the error
    ends the run with a traceback and a non-zero exit."""
    import ast
    import tooling_phase
    from repro_torch.core.sssp import metrics_dict
    hg, dg, src, (d, p, m), (bd, bp), _ = _fault1_case()
    tree = dict(host=hg, source=src, dist=d.numpy(), parent=p.numpy(),
                metrics=metrics_dict(m))
    got = tooling_phase.against_tree("seed 3679", "bellman_ford", tree, dg,
                                     bd, bp, "cpu")
    assert len(got["fault1"]["roots"]) == 1
    wrong = dict(tree, dist=bd.numpy() + np.float32(0.5))
    with pytest.raises(AssertionError, match="other than by reference fault"):
        tooling_phase.against_tree("seed 3679", "bellman_ford", wrong, dg,
                                   bd, bp, "cpu")
    loop = bp.clone()
    loop[int(np.flatnonzero(bp.numpy() != src)[0])] = src
    exact = dict(tree, dist=bd.numpy(), parent=bp.numpy())
    with pytest.raises(AssertionError, match="parent edge is not tight"):
        tooling_phase.against_tree("seed 3679", "bellman_ford", exact, dg,
                                   bd, loop, "cpu")
    main = next(f for f in ast.parse(Path(chip_smoke.__file__).read_text())
                .body if isinstance(f, ast.FunctionDef) and f.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "tooling_phase"]
    assert len(calls) == 1
    guarded = [n for t in ast.walk(main) if isinstance(t, ast.Try)
               and t.handlers for n in ast.walk(t) if n in calls]
    assert not guarded
