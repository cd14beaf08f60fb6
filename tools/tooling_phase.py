"""``chip_smoke.py``'s phase 4e, the workload side of the port on the card,
and the phase alone:

    python3 tools/tooling_phase.py [--parts abcde] [--explore]

Alone it builds the kernels, generates phase 3's graphs
(``kronecker(20,16)`` and, for part a, ``road_grid(1024)``) and solves
each graph's ``blocked`` tree from its max-degree vertex, as phase 3
does; inside the smoke it takes phase 3's trees.  Each part prints
``[tooling]`` lines; the last line is the phase's numbers as JSON.

a. The baselines (``core/baselines.py``): ``bellman_ford`` on both
   graphs and ``delta_stepping`` (one ``delta`` a graph, ``DELTA_PICK``)
   from the tree's source.  Each ``dist`` must be bitwise the tree's but
   at vertices shown to be reference fault 1 (:func:`explain_fault1`),
   each parent tree valid (``chip_smoke.check_fixpoint``: every reached
   vertex has a tight parent edge, no edge improves ``dist``).
   ``--explore`` runs the three deltas of ``benchmarks/run.py`` instead,
   each capped at ``EXPLORE_MAX_ITERS`` iterations, and reports which
   finish and agree (how ``DELTA_PICK`` was chosen).
b. The weight variant ``make_variant(kronecker(20,16), power=4)``
   (integer weights 1..15): ``blocked`` tree solves unfused and fused
   (``edge_relax`` and ``edge_relax_fused``, counted), ``bellman_ford``
   against scipy's Dijkstra, and EIC's ``dist`` bitwise Bellman-Ford's
   under part a's rule.
c. Zipf traffic: ``make_traffic`` over kronecker and the variant, 32
   items served closed-loop through ``GraphRegistry`` and ``QueryRouter``
   on ``blocked`` (``edge_relax_batch``, counted); every answer bitwise
   the single tier's solve of the same spec.
d. ``minibatch_lg`` (``tools/gnn_phase.py::minibatch_phase``).
e. The five ported examples (``examples/torch/``), each ``main`` called
   in this process on the card; each must print its correctness line.

Needs one card.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

DELTA_FRACTIONS = (0.1, 0.5, 1.0)        # benchmarks/run.py, x max_w
# the fraction of max_w each graph's delta_stepping runs at: the fastest
# of DELTA_FRACTIONS that finished and agreed with the tree (``--explore``
# on an H100: kronecker 0.104 s against 0.131 and 0.306; road 2.76 s
# against 4.61 and, at 0.1, no end in 20,000 iterations)
DELTA_PICK = {"kronecker(20,16)": 1.0, "road_grid(1024)": 1.0}
EXPLORE_MAX_ITERS = 20_000
# the cuts of depth chip_smoke.py makes for its time limit, in the order
# the phase gives them up (uncut, the smoke took 1,167.1 s of its 1,200 on
# an H100): the LM and GNN examples (the CPU tests keep them), Δ-stepping
# on road (2.8 s), then minibatch_lg's timed steps down to one, then
# (paying for phase 4f) the Zipf traffic from 32 items to 16 (part c took
# 37.5 s for 32)
SMOKE_CUTS = dict(examples=("quickstart", "serving_demo"),
                  road_delta_stepping=False, minibatch_steps=2,
                  traffic_n=16)
VARIANT_POWER = 4
TRAFFIC = dict(n=32, seed=0, max_batch=8)
# the served answer's normalized metrics that count logical work (the
# others count this port's launches and tiles, which batching changes)
TRAFFIC_LOGICAL = ("n_steps", "n_rounds", "n_relax", "n_updates",
                   "n_pruned", "nFrontier", "nSync", "nTrav", "reachable")
EXAMPLES = (("quickstart", [], "correctness vs Dijkstra oracle: OK"),
            ("serving_demo", [], "traced solve on "),
            ("gnn_sssp_features", [], "final nearest-anchor accuracy: "),
            ("serve_lm", [], "generated shape: (4, 32)"),
            ("train_lm", ["--steps", "10"],
             "finished at step 10 (preempted=False)"))


def _cs():
    import chip_smoke
    return chip_smoke


def tree_of(name, hg, device) -> dict:
    """Phase 3's tree of ``hg`` for the phase run alone: the ``blocked``
    solve from the max-degree vertex, on the host as numpy, with its
    counters."""
    cs = _cs()
    from repro_torch.core.sssp import metrics_dict
    source = int(np.argmax(hg.deg))
    d, p, m, secs, _ = cs.solve(hg.to_device(device), source, "blocked",
                                device)
    cs.log(f"[tooling] {name}: phase 3's blocked tree from {source} in "
           f"{secs!r} s")
    return dict(host=hg, source=source, dist=d.cpu().numpy(),
                parent=p.cpu().numpy(), metrics=metrics_dict(m))


def explain_fault1(hg, dist, want, want_parent, lbs, what) -> dict:
    """The vertices where EIC's ``dist`` is not bitwise an exact solver's
    ``want`` (Bellman-Ford's), each shown to be reference fault 1
    (ROADMAP queue 3) or the phase fails.  A vertex ``v`` is a root of
    the fault where ``dist[v] > want[v]``, its exact parent ``u =
    want_parent[v]`` has ``dist[u]`` bitwise ``want[u]``, and the
    candidate ``c = fl(dist[u] + w(u, v))`` that gives ``want[v]`` was
    dropped: ``c`` is a window's lower edge ``lb`` (one of ``lbs``, from
    a trace of the EIC solve) and the push band below it starts above
    ``u``, ``fl(lb - maxW) > dist[u]``.  A vertex is downstream of the
    fault where ``dist[v] > want[v]`` and its exact parent is a root or
    downstream.  Returns ``{"roots": [...], "downstream": [...]}``."""
    d = np.asarray(dist, np.float32)
    bw = np.asarray(want, np.float32)
    differ = np.flatnonzero(d.view(np.int32) != bw.view(np.int32))
    lbs = np.unique(np.asarray(lbs, np.float32))
    max_w = np.float32(hg.max_w)
    roots, downstream, bad = [], [], []
    for v in differ[np.argsort(bw[differ], kind="stable")]:
        v = int(v)
        u = int(want_parent[v])
        if not d[v] > bw[v] or u < 0:
            bad.append(v)
        elif u in roots or u in downstream:
            downstream.append(v)
        elif d[u] == bw[u]:
            lo, hi = hg.row_ptr[u], hg.row_ptr[u + 1]
            ws = hg.w[lo:hi][hg.dst[lo:hi] == v].astype(np.float32)
            cand = np.float32(d[u]) + ws
            dropped = [c for c in cand if c == bw[v] and c in lbs
                       and np.float32(c - max_w) > d[u]]
            (roots if dropped else bad).append(v)
        else:
            bad.append(v)
    if bad:
        raise AssertionError(
            f"{what}: {len(bad)} vertices differ from the exact solver's "
            f"dist other than by reference fault 1, the first {bad[:5]}: "
            f"EIC {d[bad[:5]].tolist()} against {bw[bad[:5]].tolist()}")
    return dict(roots=roots, downstream=downstream)


def window_edges(dg, source, iterations: int, device) -> np.ndarray:
    """Every window's lower edge of the EIC ``blocked`` tree solve from
    ``source`` (a traced solve, the ring large enough for all
    ``iterations``)."""
    from repro_torch.core.sssp import sssp
    from repro_torch.obs import materialize_trace
    out = sssp(dg, source, backend="blocked", device=device, trace=True,
               trace_capacity=iterations + 16)
    tr = materialize_trace(out[3])
    if tr.dropped:
        raise AssertionError("the traced solve overflowed its ring")
    return tr.columns["lb"]


def against_tree(name, what, tree, dg, dist, parent, device) -> dict:
    """An exact solver's ``(dist, parent)`` against phase 3's EIC tree:
    ``dist`` bitwise but at fault-1 vertices (:func:`explain_fault1`,
    the windows traced only where some vertex differs), the parent tree
    valid; returns the fault-1 vertices and the parents that differ from
    the tree's (exact ties)."""
    cs = _cs()
    d = dist.cpu().numpy()
    differ = int((d.view(np.int32) != tree["dist"].view(np.int32)).sum())
    fault = dict(roots=[], downstream=[])
    if differ:
        lbs = window_edges(dg, tree["source"],
                           int(tree["metrics"]["n_host_syncs"]), device)
        fault = explain_fault1(tree["host"], tree["dist"], d,
                               parent.cpu().numpy(), lbs, f"{name} {what}")
    cs.check_fixpoint(dg, dist, parent, tree["source"], f"{name} {what}")
    ties = int((parent.cpu().numpy() != tree["parent"]).sum())
    return dict(fault1=fault, tie_parents=ties)


def timed_baseline(fn, device):
    """``(dist, parent, metrics dict, seconds)`` of one baseline call."""
    cs = _cs()
    from repro_torch.core.sssp import metrics_dict
    (d, p, m), secs = cs.timed(fn, device)
    return d, p, metrics_dict(m), secs


LOGICAL = ("n_rounds", "n_extended", "n_trav", "n_updates")


def baselines_part(trees, device, explore=False,
                   road_delta_stepping=True) -> dict:
    """Part a on each graph of ``trees`` (phase 3's)."""
    cs = _cs()
    from repro_torch.core.baselines import bellman_ford, delta_stepping
    out = {}
    for name, tree in trees.items():
        hg, s = tree["host"], tree["source"]
        dg = hg.to_device(device)
        eic = {f: tree["metrics"][f] for f in LOGICAL + ("n_host_syncs",)}
        d, p, md, secs = timed_baseline(lambda: bellman_ford(dg, s), device)
        row = dict(bellman_ford=dict(
            seconds=secs, iterations=md["n_rounds"],
            host_reads=int(md["n_host_syncs"]),
            **{f: md[f] for f in LOGICAL},
            **against_tree(name, "bellman_ford", tree, dg, d, p, device)),
            eic=eic)
        cs.log(f"[tooling] 4e-a {name} bellman_ford from {s}: "
               + json.dumps(row["bellman_ford"]) + "; EIC " + json.dumps(eic))
        fractions = DELTA_FRACTIONS if explore else (
            (DELTA_PICK[name],) if road_delta_stepping
            or not name.startswith("road") else ())
        for frac in fractions:
            delta = frac * float(hg.max_w)
            cap = EXPLORE_MAX_ITERS if explore else 1_000_000
            d, p, md, secs = timed_baseline(
                lambda: delta_stepping(dg, s, delta, max_iters=cap), device)
            r = dict(fraction=frac, delta=delta, seconds=secs,
                     iterations=int(md["n_host_syncs"]) - 1,
                     host_reads=int(md["n_host_syncs"]),
                     **{f: md[f] for f in LOGICAL})
            truncated = int(md["n_host_syncs"]) >= cap
            if explore:
                r["truncated"] = truncated
                r["bitwise_tree"] = bool(np.array_equal(
                    d.cpu().numpy().view(np.int32),
                    tree["dist"].view(np.int32)))
            elif truncated:
                raise AssertionError(f"{name} delta_stepping did not finish "
                                     f"in {cap} iterations")
            else:
                r.update(against_tree(name, f"delta_stepping {frac} max_w",
                                      tree, dg, d, p, device))
            row[f"delta_stepping {frac}"] = r
            cs.log(f"[tooling] 4e-a {name} delta_stepping at {frac} x max_w "
                   "= " + json.dumps(r))
        out[name] = row
        del dg
    return out


def variant_part(tree, device):
    """Part b on phase 3's kronecker; returns the numbers and the
    variant's host graph."""
    cs = _cs()
    from repro_torch.core.baselines import bellman_ford
    from repro_torch.core.graph import build_blocked
    from repro_torch.core.sssp import LOGICAL_METRIC_FIELDS, metrics_dict
    from repro_torch.data.weights import make_variant
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    name = f"kronecker(20,16) pow{VARIANT_POWER}"
    t0 = time.perf_counter()
    var = make_variant(tree["host"], power=VARIANT_POWER)
    variant_s = time.perf_counter() - t0
    s = int(np.argmax(var.deg))
    dg = var.to_device(device)
    bg, layout_s = cs.timed(lambda: build_blocked(dg), device)
    LAUNCHES.reset()
    kd, kp, km, ks, _ = cs.solve(dg, s, "blocked", device, layout=bg)
    launches = LAUNCHES.edge_relax
    LAUNCHES.reset()
    fd, fp, fm, fs, _ = cs.solve(dg, s, "blocked", device, layout=bg,
                                 fused_rounds=cs.FUSED_ROUNDS)
    fused_launches, stray = LAUNCHES.edge_relax_fused, LAUNCHES.edge_relax
    if launches <= 0 or fused_launches <= 0 or stray:
        raise AssertionError(f"{name}: edge_relax {launches}, "
                             f"edge_relax_fused {fused_launches} launches "
                             f"(and {stray} edge_relax in the fused solve)")
    kmd, fmd = metrics_dict(km), metrics_dict(fm)
    fused_ties = cs.same_tree_up_to_ties(var, fd, fp, kd, kp, None,
                                         f"{name} fused against unfused")
    bad = [f for f in LOGICAL_METRIC_FIELDS if kmd[f] != fmd[f]]
    if bad:
        raise AssertionError(f"{name}: fused and unfused counters differ: "
                             f"{bad}")
    bd, bp, bmd, bsecs = timed_baseline(lambda: bellman_ford(dg, s), device)
    ref = cs.scipy_dist(var, s)
    cs.check_against_dijkstra(ref, bd)
    vtree = dict(host=var, source=s, dist=kd.cpu().numpy(),
                 parent=kp.cpu().numpy(), metrics=kmd)
    vs = against_tree(name, "bellman_ford", vtree, dg, bd, bp, device)
    out = dict(variant_s=variant_s, layout_s=layout_s, source=s,
               max_w=float(var.max_w), solve_s=ks, fused_solve_s=fs,
               launches=launches, fused_launches=fused_launches,
               iterations=int(kmd["n_host_syncs"]),
               fused_iterations=int(fmd["n_host_syncs"]),
               fused_tie_parents=fused_ties, bellman_ford_s=bsecs,
               bellman_ford_rounds=bmd["n_rounds"],
               fault1_vertices=len(vs["fault1"]["roots"])
               + len(vs["fault1"]["downstream"]), **vs)
    cs.log(f"[tooling] 4e-b {name} (max_w {var.max_w}): " + json.dumps(out))
    del dg, bg
    return out, var


def traffic_part(graphs, device, n: int = TRAFFIC["n"]) -> dict:
    """Part c over ``graphs`` (gid -> host graph, hottest first): ``n``
    items of Zipf traffic."""
    cs = _cs()
    from repro_torch.api import EngineConfig, Solver
    from repro_torch.data.traffic import make_traffic
    from repro_torch.kernels.edge_relax.ops import LAUNCHES
    from repro_torch.serve.queries import finalize
    from repro_torch.serve.registry import GraphRegistry
    from repro_torch.serve.router import QueryRouter
    traffic = make_traffic(graphs, n, seed=TRAFFIC["seed"])
    cfg = EngineConfig(backend="blocked", max_batch=TRAFFIC["max_batch"],
                       registry_capacity=4 * len(graphs))
    registry = GraphRegistry(config=cfg, device=device)
    for gid, g in graphs.items():
        registry.register(gid, g)
    router = QueryRouter(registry, config=cfg, devices=[device])
    shares = {}
    for item in traffic:
        shares[item.query.gid] = shares.get(item.query.gid, 0) + 1
    router.plan_placement(shares)
    # the engines' builds and each kernel's first use (as phase 3f warms)
    _, warm_s = cs.timed(lambda: router.warmup(kinds=("p2p",)), device)
    LAUNCHES.reset()
    router.start()
    try:
        t0 = time.perf_counter()
        futs = [router.submit(it.query, priority=it.priority)
                for it in traffic]
        answers = [f.result(timeout=600) for f in futs]
        cs.sync(device)
        served_s = time.perf_counter() - t0
    finally:
        router.stop()
    launches = dict(edge_relax_batch=LAUNCHES.edge_relax_batch,
                    edge_relax=LAUNCHES.edge_relax)
    if launches["edge_relax_batch"] <= 0:
        raise AssertionError(f"traffic: launches {launches}")
    stats = router.stats()
    kinds = {}
    ties = 0
    sessions = {}
    for item, a in zip(traffic, answers):
        q = item.query
        kinds[q.kind] = kinds.get(q.kind, 0) + 1
        if q.gid not in sessions:
            eng = registry.peek(q.gid, device=device)
            sessions[q.gid] = Solver.open(
                eng.g, EngineConfig(backend="blocked"), layout=eng.layout,
                device=device)
        param = {"p2p": q.target, "bounded": q.bound,
                 "knear": q.k}.get(q.kind)
        d, p, m = sessions[q.gid].solve(cs.spec_of(q.kind, q.source, param))
        w = finalize(q, graphs[q.gid].deg, d, p, m)
        what = f"traffic {q.gid} {q.kind} from {q.source}"
        ties += cs.same_tree_up_to_ties(
            graphs[q.gid], torch.from_numpy(a.dist),
            torch.from_numpy(a.parent), torch.from_numpy(w.dist),
            torch.from_numpy(w.parent), None, what)
        if {k: a.metrics[k] for k in TRAFFIC_LOGICAL} != \
                {k: w.metrics[k] for k in TRAFFIC_LOGICAL} \
                or a.path != w.path or a.nearest != w.nearest:
            raise AssertionError(f"{what}: metrics, path or nearest list "
                                 "differ from the single tier's")
    out = dict(queries=len(traffic), served_s=served_s,
               queries_per_s=len(traffic) / served_s, warm_s=warm_s,
               kinds=kinds, by_graph=shares, launches=launches,
               batches=stats["n_batches"], occupancy=stats["occupancy"],
               tie_parents=ties)
    cs.log("[tooling] 4e-c Zipf traffic through the router: "
           + json.dumps(out) + "; every answer bitwise the single tier's")
    return out


def examples_part(device, names=None) -> dict:
    """Part e: each ported example's ``main`` (or those of ``names``) on
    the card, its output captured and its correctness line checked."""
    cs = _cs()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, want in EXAMPLES:
            if names is not None and name not in names:
                continue
            argv = argv + ["--device", str(device)]
            if name == "serving_demo":
                argv += ["--trace-out", str(Path(tmp) / "trace.json")]
            if name == "train_lm":
                argv += ["--ckpt-dir", str(Path(tmp) / "ckpt")]
            spec = importlib.util.spec_from_file_location(
                f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(argv)
            cs.sync(device)
            secs = time.perf_counter() - t0
            lines = buf.getvalue().splitlines()
            for line in lines:
                cs.log(f"[tooling] 4e-e {name} | {line}")
            hit = [ln for ln in lines if want in ln]
            if not hit:
                raise AssertionError(f"example {name}: no line {want!r}")
            out[name] = dict(seconds=secs, line=hit[-1].strip())
    cs.log("[tooling] 4e-e examples: " + json.dumps(out))
    return out


def tooling_phase(trees, device, parts="abcde", explore=False,
                  cut=False) -> dict:
    """Phase 4e over phase 3's ``trees`` (name -> :func:`tree_of`'s dict;
    kronecker is needed for parts b and c); ``cut`` makes
    ``SMOKE_CUTS``."""
    cs = _cs()
    out = dict(cuts=SMOKE_CUTS if cut else None)
    kron = trees["kronecker(20,16)"]
    if "a" in parts:
        out["baselines"] = baselines_part(
            trees, device, explore,
            road_delta_stepping=not cut or SMOKE_CUTS["road_delta_stepping"])
        cs.mark("phase 4e-a (baselines)")
    var = None
    if "b" in parts or "c" in parts:
        out["variant"], var = variant_part(kron, device)
        cs.mark("phase 4e-b (weight variant)")
    if "c" in parts:
        out["traffic"] = traffic_part(
            {"social": kron["host"], f"social_pow{VARIANT_POWER}": var},
            device, SMOKE_CUTS["traffic_n"] if cut else TRAFFIC["n"])
        cs.mark("phase 4e-c (Zipf traffic)")
    del var
    cs.release_card("before phase 4e-d")
    if "d" in parts:
        sys.path.insert(0, str(ROOT / "tools"))
        import gnn_phase
        out["minibatch_lg"] = gnn_phase.minibatch_phase(
            device, steps=SMOKE_CUTS["minibatch_steps"] if cut else None)
        cs.mark("phase 4e-d (minibatch_lg)")
    if "e" in parts:
        out["examples"] = examples_part(
            device, SMOKE_CUTS["examples"] if cut else None)
        cs.mark("phase 4e-e (examples)")
        cs.release_card("after phase 4e")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="abcde",
                    help="which parts of phase 4e to run (default abcde)")
    ap.add_argument("--explore", action="store_true",
                    help="part a: every delta of benchmarks/run.py, capped")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tooling_phase: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.data.generators import kronecker, road_grid
    from repro_torch.kernels import _build
    device = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[setup] build in {time.perf_counter() - t0:.1f} s")
    graphs = [("kronecker(20,16)", kronecker(**cs.KRON))]
    if "a" in args.parts:
        graphs.append(("road_grid(1024)", road_grid(**cs.ROAD)))
    trees = {name: tree_of(name, hg, device) for name, hg in graphs}
    t0 = time.perf_counter()
    out = tooling_phase(trees, device, args.parts, args.explore)
    cs.log(f"[time] phase 4e: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"tooling": out}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
