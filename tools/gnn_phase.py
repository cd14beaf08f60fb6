"""``chip_smoke.py``'s phase 4d alone: the four GNN models trained at full
width and the anchor-feature GIN, without the rest of the smoke.

    python3 tools/gnn_phase.py [--scale 20] [--profile]

Builds the kernels, generates ``kronecker(scale, 16, seed=1)`` (the
smoke's graph at scale 20, about 40 s of numpy), then runs
``chip_smoke.gnn_phase``: GIN, GatedGCN, PNA and DimeNet at full width
on ``full_graph_sm`` and ``molecule`` (each step on the card against the
CPU's, DimeNet's basis bitwise), then 8 anchors solved as one batched
tree on ``blocked`` and gin-tu trained for 60 steps on their features:
the same ``[gnn]`` and ``[anchors]`` lines and checks as in the smoke.
With ``--profile``, then one step of each model on ``full_graph_sm``
under ``torch.profiler`` after a warm-up (``[gnn profile]`` lines: the
step's wall ms unprofiled, its device kernel ms and kernel count, the
busy share, the top kernels).  Prints the card's name and power limit
first and the phase's numbers as one JSON line last.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def profile_steps(cs, device) -> dict:
    """Each model's ``full_graph_sm`` step: unprofiled wall ms (the median
    of 3 after 2 warm-ups), then one profiled step's device kernel ms."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.train import optimizer as opt
    arrays, n_graphs, graph_level = cs.gnn_cell_batch("full_graph_sm")
    gb = GraphBatch(edge_feat=None, n_graphs=n_graphs,
                    **{k: torch.from_numpy(v) for k, v in arrays.items()}
                    ).to(device)
    out = {}
    for arch in cs.GNN_ARCHS:
        mod, cfg, ocfg, step = cs.gnn_model(arch, "full_graph_sm",
                                            graph_level)
        params = mod.init_params(cfg, torch.Generator(device=device)
                                 .manual_seed(0))
        state = (params, opt.adamw_init(params, ocfg))
        state, secs, _ = cs.timed_steps(step, state, [gb] * 5, arch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cs.timed_steps(step, state, [gb], arch + " profiled")
        kern = cs.trace_kernels(prof.key_averages(), arch + " step")
        device_ms = sum(e.self_device_time_total for e in kern) / 1e3
        wall_ms = float(np.median(secs[2:])) * 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
        out[arch] = dict(wall_ms=wall_ms, device_ms=device_ms,
                         kernels=sum(e.count for e in kern),
                         busy=device_ms / wall_ms,
                         top={e.key[:60]: e.self_device_time_total / 1e3
                              for e in top})
        cs.log(f"[gnn profile] {arch} full_graph_sm: " + json.dumps(
            out[arch]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="kronecker scale of the anchor graph (default 20)")
    ap.add_argument("--profile", action="store_true",
                    help="then profile one step of each model")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gnn_phase: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.data.generators import kronecker
    from repro_torch.kernels import _build
    device = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[setup] build in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kron = kronecker(args.scale, cs.KRON["edge_factor"], seed=cs.KRON["seed"])
    cs.log(f"[setup] kronecker({args.scale},{cs.KRON['edge_factor']}) in "
           f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = cs.gnn_phase(kron, device)
    cs.log(f"[time] phase 4d: {time.perf_counter() - t0:.1f} s")
    if args.profile:
        out["profile"] = profile_steps(cs, device)
    print(json.dumps({"gnn": out}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
