"""Quickstart: EIC SSSP on a Graph500 Kronecker graph through the
declarative solver facade (``repro_torch.api``), on the card.

    PYTHONPATH=src python examples/torch/quickstart.py [--scale 12] \\
        [--device cuda|cpu]

``Solver.open`` owns layout building and engine-tier resolution; every
query is a ``SolveSpec`` (tree / p2p / bounded / knear) and every result
a ``SolveResult`` with lazy path reconstruction.  The same flow and
lines as ``examples/quickstart.py``, on ``--device`` (default ``cuda``;
without a card that fails, ``--device cpu`` runs the plain versions).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import SolveSpec, Solver  # noqa: E402
from repro_torch.core.baselines import bellman_ford, dijkstra_host  # noqa: E402
from repro_torch.data.generators import kronecker  # noqa: E402


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"generating Graph500 Kronecker graph: scale={args.scale} "
          f"edge_factor={args.edge_factor}")
    g = kronecker(args.scale, args.edge_factor, seed=1)
    # random source (paper methodology; hub sources inflate the first window)
    src = int(np.random.default_rng(0).choice(np.where(g.deg > 0)[0]))
    print(f"|V|={g.n} |E|={g.m // 2} source={src} (max degree {g.deg.max()})")

    solver = Solver.open(g, device=args.device)    # default: single device
    device = solver.device_graph.device
    spec = SolveSpec.tree(src)
    t0 = time.perf_counter()
    solver.solve(spec).block_until_ready()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver.solve(spec).block_until_ready()
    t_run = time.perf_counter() - t0

    nm = res.normalized()
    print(f"\nEIC heuristic SSSP: {t_run*1e3:.1f} ms "
          f"(+{t_first - t_run:.1f}s first call, once)")
    print(f"  nFrontier={nm['nFrontier']:.3f}  (paper: 1.01-1.10 — "
          f"~all extended paths are shortest paths)")
    print(f"  nSync    ={nm['nSync']:.2f} x log2|V| (paper: 1.55-6.13)")
    print(f"  nTrav    ={nm['nTrav']:.2f} edges/vertex vs |E|/|V|="
          f"{g.m/2/g.n:.1f} (paper: < half the edges)")
    print(f"  steps={nm['n_steps']} rounds={nm['n_rounds']} "
          f"reachable={nm['reachable']}")

    dref, _ = dijkstra_host(g, src)
    dist = res.dist.cpu().numpy()
    ok = np.allclose(np.where(np.isfinite(dist), dist, -1),
                     np.where(np.isfinite(dref), dref, -1), rtol=1e-4)
    print(f"\ncorrectness vs Dijkstra oracle: {'OK' if ok else 'MISMATCH'}")

    # an early-exit point-to-point query on the same session (the layout
    # is already built); the target distance is bitwise equal to the full
    # tree's, at a fraction of the stepping rounds
    tgt = int(np.flatnonzero(np.isfinite(dist))[-1])
    p2p = solver.solve(SolveSpec.p2p(src, tgt)).block_until_ready()
    path = p2p.paths()
    print(f"p2p {src}->{tgt}: dist={p2p.distance():.4f} "
          f"hops={len(path) - 1 if path else None} "
          f"rounds={int(p2p.metrics.n_rounds)} "
          f"(tree ran {nm['n_rounds']})")

    bellman_ford(solver.device_graph, src)
    _sync(device)
    t0 = time.perf_counter()
    bf_dist, _, bf_m = bellman_ford(solver.device_graph, src)
    _sync(device)
    t_bf = time.perf_counter() - t0
    eic_trav = int(res.metrics.n_trav) + int(res.metrics.n_pull_trav)
    print(f"Bellman-Ford baseline: {t_bf*1e3:.1f} ms "
          f"({int(bf_m.n_trav)} traversals vs EIC {eic_trav})")
    return ok


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
