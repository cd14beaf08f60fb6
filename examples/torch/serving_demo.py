"""Serving demo: the router and its per-device schedulers under Zipf
traffic, on the card.

    PYTHONPATH=src python examples/torch/serving_demo.py [--scale 10] \\
        [--queries 32] [--device cuda|cpu]

Registers a road grid and a Kronecker graph, plans placement from the
expected traffic shares, warms every replica engine, starts the
background workers (one per device), streams a Zipf-skewed mixed query
load (p2p / bounded / k-nearest / tree) through the router, and prints
per-kind samples plus placement and serving counters.

At exit it prints the serving plane's metrics snapshot (the one
registry/scheduler/router ``MetricsRegistry``), then runs one *traced*
solve on the hottest graph and writes its per-round solve trace as a
Perfetto/Chrome-trace JSON (``--trace-out``, default
``serving_demo_trace.json`` — load it at https://ui.perfetto.dev).
The same flow and lines as ``examples/serving_demo.py``; the router
serves on ``--device`` (default ``cuda``; without a card that fails).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
from repro_torch.api import EngineConfig, SolveSpec, Solver  # noqa: E402
from repro_torch.core.sssp import resolve_device  # noqa: E402
from repro_torch.data.generators import kronecker, road_grid  # noqa: E402
from repro_torch.data.traffic import make_traffic  # noqa: E402
from repro_torch.obs import write_perfetto  # noqa: E402
from repro_torch.serve.registry import GraphRegistry  # noqa: E402
from repro_torch.serve.router import QueryRouter  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--rate-qps", type=float, default=None,
                    help="open-loop arrival pacing (default: closed loop)")
    ap.add_argument("--trace-out", default="serving_demo_trace.json",
                    help="write a traced solve's Perfetto JSON here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n = 1 << args.scale
    graphs = {
        "social": kronecker(args.scale, 8, seed=2),      # hottest
        "road": road_grid(int(np.sqrt(n)), seed=5),
    }
    # one EngineConfig drives the registry and the router
    cfg = EngineConfig(max_batch=args.max_batch,
                       registry_capacity=4 * len(graphs))
    registry = GraphRegistry(config=cfg, device=device)
    for gid, g in graphs.items():
        registry.register(gid, g)
        print(f"registered {gid!r}: |V|={g.n} |E|={g.m // 2}")

    router = QueryRouter(registry, config=cfg, devices=[device])
    print(f"router over {router.n_devices} device(s)")
    traffic = make_traffic(graphs, args.queries, seed=0,
                           rate_qps=args.rate_qps)
    shares = {}
    for item in traffic:
        shares[item.query.gid] = shares.get(item.query.gid, 0) + 1
    placement = router.plan_placement(shares)
    print(f"placement: {placement}")
    t0 = time.perf_counter()
    router.warmup(kinds=("p2p", "bounded", "knear", "tree"))
    print(f"warmup (builds + first calls): "
          f"{time.perf_counter() - t0:.1f}s")

    router.start()
    t0 = time.perf_counter()
    futs = []
    try:
        for item in traffic:
            if args.rate_qps is not None:       # open-loop pacing
                lag = item.arrival_s - (time.perf_counter() - t0)
                if lag > 0:
                    time.sleep(lag)
            futs.append((item, router.submit(item.query,
                                             priority=item.priority)))
        results = [(item, fut.result(timeout=600)) for item, fut in futs]
    finally:
        router.stop()
    elapsed = time.perf_counter() - t0

    shown = set()
    for item, res in results:
        q = item.query
        if q.kind in shown:
            continue
        shown.add(q.kind)
        where = f"@{res.served_by}"
        if q.kind == "p2p":
            hops = len(res.path) - 1 if res.path else None
            print(f"[{q.gid}{where}] p2p {q.source}->{q.target}: "
                  f"dist={res.distance:.4f} hops={hops} "
                  f"({res.latency_s * 1e3:.0f} ms)")
        elif q.kind == "bounded":
            print(f"[{q.gid}{where}] bounded src={q.source} "
                  f"D={q.bound:.2f}: "
                  f"{int(np.isfinite(res.dist).sum())} vertices in range")
        elif q.kind == "knear":
            v, d = res.nearest[-1]
            print(f"[{q.gid}{where}] knear src={q.source} k={q.k}: "
                  f"k-th neighbor {v} at {d:.4f}")
        else:
            print(f"[{q.gid}{where}] tree src={q.source}: "
                  f"{res.metrics['reachable']} reachable, "
                  f"nSync={res.metrics['nSync']:.2f}")

    lats = np.array([res.latency_s for _, res in results])
    stats = router.stats()
    print(f"\n{len(results)} queries in {elapsed:.2f}s "
          f"({len(results) / elapsed:.1f} q/s, warmed)")
    print(f"latency p50={np.percentile(lats, 50) * 1e3:.0f} ms "
          f"p99={np.percentile(lats, 99) * 1e3:.0f} ms; "
          f"occupancy={stats['occupancy']:.2f} over "
          f"{stats['n_batches']} batches on {stats['n_devices']} devices; "
          f"replications={stats['n_replications']}; "
          f"registry hit rate={stats['registry']['hit_rate']:.2f}")
    per_dev = {s["name"]: s["n_done"] for s in stats["schedulers"]
               if s["n_done"]}
    print(f"queries per scheduler: {per_dev}")

    # the same numbers, through the observability plane: one metrics
    # registry covers the engine registry, every scheduler, and the router
    print("\nmetrics snapshot (non-zero series):")
    for name, entry in sorted(registry.metrics.snapshot().items()):
        if entry["type"] == "histogram":
            if entry["count"]:
                print(f"  {name}: count={entry['count']} "
                      f"p50={entry['p50'] * 1e3:.1f}ms "
                      f"p99={entry['p99'] * 1e3:.1f}ms")
        elif entry["value"]:
            print(f"  {name}: {entry['value']}")

    # one traced solve on the hottest graph -> Perfetto JSON of its
    # per-round stepping behavior (solve/step/round/invocation tracks)
    hot = max(shares, key=shares.get)
    with Solver.open(graphs[hot], EngineConfig(trace=True),
                     device=device) as solver:
        res = solver.solve(SolveSpec.tree(0))
    write_perfetto(res.trace, args.trace_out, name=f"sssp:{hot}")
    print(f"\ntraced solve on {hot!r}: {res.trace.n_records} rounds, "
          f"{int(res.metrics.n_relax)} relaxations -> {args.trace_out}")
    return len(results) == args.queries


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
