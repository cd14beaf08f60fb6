"""``chip_smoke.py``'s phase 4d alone: the four GNN models trained at full
width and the anchor-feature GIN, without the rest of the smoke.

    python3 tools/gnn_phase.py [--scale 20] [--profile]

Builds the kernels, generates ``kronecker(scale, 16, seed=1)`` (the
smoke's graph at scale 20, about 40 s of numpy), then runs
``chip_smoke.gnn_phase``: GIN, GatedGCN, PNA and DimeNet at full width
on ``full_graph_sm`` and ``molecule`` (each step on the card against the
CPU's, DimeNet's basis bitwise), then 8 anchors solved as one batched
tree on ``blocked`` and gin-tu trained for 30 steps on their features:
the same ``[gnn]`` and ``[anchors]`` lines and checks as in the smoke.
With ``--profile``, then one step of each model on ``full_graph_sm``
under ``torch.profiler`` after a warm-up (``[gnn profile]`` lines: the
step's wall ms unprofiled, its device kernel ms and kernel count, the
busy share, the top kernels).  Prints the card's name and power limit
first and the phase's numbers as one JSON line last.  Needs one card.

The sampled cell ``minibatch_lg`` (``chip_smoke.py`` phase 4e-d, run by
``tools/tooling_phase.py``) lives here too: :func:`csr_by_receiver`
builds the sampler's CSR on the card, :func:`sampled_batch` one step's
padded subgraph from ``NeighborSampler`` and ``flat_subgraph``, and
:func:`minibatch_phase` trains the four models on it at full width.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# the sampled cell: configs/gnn_common.py's minibatch_lg, one device
MINIBATCH = dict(shape="minibatch_lg", seed=0, steps=4, cpu_seeds=64)


def profile_steps(cs, device) -> dict:
    """Each model's ``full_graph_sm`` step: unprofiled wall ms (the median
    of 3 after 2 warm-ups), then one profiled step's device kernel ms."""
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

def csr_by_receiver(senders, receivers, n: int, device):
    """The sampler's CSR of a directed edge list, built on ``device`` and
    copied to the host: ``col[row_ptr[v]:row_ptr[v + 1]]`` are the senders
    of ``v``'s in-edges in edge order (a stable sort of the receivers),
    ``row_ptr`` int64 from a ``bincount`` and a ``cumsum``.  Returns
    numpy ``(row_ptr, col)``, ``col`` with the senders' dtype."""
    rcv = torch.from_numpy(receivers).to(device)
    order = torch.sort(rcv, stable=True).indices
    col = torch.from_numpy(senders).to(device)[order]
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(rcv, minlength=n), 0, out=row_ptr[1:])
    return row_ptr.cpu().numpy(), col.cpu().numpy()


def cell_pads(batch_nodes: int):
    """``(pad_nodes, pad_edges, pad_triplets)`` of a sampled batch of
    ``batch_nodes`` seeds, in ``minibatch_lg``'s proportions (181,248 and
    184,320 at 1,024 seeds: 177 nodes and 180 edges a seed) and DimeNet's
    ``triplet_cap`` slots an edge, as ``launch/cells.py::_gnn_cell`` pads
    them on one device."""
    from repro_torch.configs.gnn_common import SHAPES
    sh = SHAPES[MINIBATCH["shape"]]
    per_node = sh["sub_nodes"] // sh["batch_nodes"]
    per_edge = sh["sub_edges"] // sh["batch_nodes"]
    return (batch_nodes * per_node, batch_nodes * per_edge,
            batch_nodes * per_edge * sh["triplet_cap"])


def sampled_batch(data, sampler, seeds, device):
    """One training step's ``GraphBatch`` on ``device``: ``sampler``'s
    fanout sample of ``seeds``, collapsed by ``flat_subgraph`` into the
    padded subgraph of :func:`cell_pads`; features, labels and positions
    gathered from ``data`` (tensors, on any device) by its node ids;
    DimeNet's triplets (``build_triplets`` at the shape's cap, seed 0)
    over the real edges, padded with masked slots.  Every row of the
    padded subgraph is a node of the batch (padded rows repeat node 0),
    as the reference's cell counts them.  Returns ``(batch, info)``:
    the host seconds of the sample, the collapse and the triplets, and
    the real node, edge and triplet counts against the pads."""
    from repro_torch.configs.gnn_common import SHAPES
    from repro_torch.data.sampler import flat_subgraph
    from repro_torch.data.triplets import build_triplets
    from repro_torch.models.gnn.common import GraphBatch
    pad_nodes, pad_edges, pad_triplets = cell_pads(len(seeds))
    t0 = time.perf_counter()
    sample = sampler.sample(seeds)
    t1 = time.perf_counter()
    snd, rcv, emask, node_ids, nmask = flat_subgraph(sample, pad_nodes,
                                                     pad_edges)
    t2 = time.perf_counter()
    e = int(emask.sum())
    kj, ji, tmask = build_triplets(snd[:e], rcv[:e],
                                   SHAPES[MINIBATCH["shape"]]["triplet_cap"],
                                   seed=0)
    pad = pad_triplets - kj.shape[0]
    zeros = np.zeros(pad, np.int32)
    kj, ji = np.concatenate([kj, zeros]), np.concatenate([ji, zeros])
    tmask = np.concatenate([tmask, np.zeros(pad, bool)])
    t3 = time.perf_counter()
    ids = torch.from_numpy(node_ids).to(data["node_feat"].device)
    gb = GraphBatch(
        node_feat=data["node_feat"].index_select(0, ids),
        senders=snd, receivers=rcv, edge_feat=None,
        graph_ids=np.zeros(pad_nodes, np.int32), n_graphs=1,
        labels=data["labels"].index_select(0, ids),
        pos=data["pos"].index_select(0, ids), edge_mask=emask,
        triplet_kj=kj, triplet_ji=ji, triplet_mask=tmask).to(device)
    info = dict(sample_ms=(t1 - t0) * 1e3, flatten_ms=(t2 - t1) * 1e3,
                triplets_ms=(t3 - t2) * 1e3, seeds=len(seeds),
                nodes=int(nmask.sum()), pad_nodes=pad_nodes, edges=e,
                pad_edges=pad_edges, triplets=int(tmask.sum()),
                pad_triplets=pad_triplets)
    return gb, info


def minibatch_cell(arch, batches, cut, device):
    """One GNN at full width on ``minibatch_lg`` (``chip_smoke.gnn_model``:
    remat, DimeNet's 4 triplet chunks, AdamW without master weights, the
    cross entropy over every row of the padded subgraph): first one step
    from the initial weights on the cut batch ``cut = (card batch, CPU
    batch)`` on the card and on the CPU, held to ``chip_smoke.same_step``
    (and DimeNet's basis bitwise); then a step on each of ``batches``
    (the first a warm-up), ms/step the median of the others, peak memory
    and the losses, which must be finite unless the CPU's step is not
    (PNA, whose node-level output overflows on a sampled subgraph in both
    packages: reference fault 5)."""
    import chip_smoke as cs
    from repro_torch.train import optimizer as opt
    from repro_torch.train.tree import tree_map
    shape = MINIBATCH["shape"]
    mod, cfg, ocfg, step = cs.gnn_model(arch, shape, False)
    params = mod.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(MINIBATCH["seed"]))
    n_params = sum(t.numel() for t in cs._leaves(params))
    cpu = tree_map(lambda t: t.cpu(), params)
    card = tree_map(lambda t: t.clone(), params)
    p1, _, m1 = step(card, opt.adamw_init(card, ocfg), cut[0])
    p1 = tree_map(lambda t: t.cpu(), p1)
    t0 = time.perf_counter()
    pc, _, mc = step(cpu, opt.adamw_init(cpu, ocfg), cut[1])
    cpu_s = time.perf_counter() - t0
    vs = cs.same_step((p1, m1), (pc, mc), f"{arch} {shape} cut batch")
    del card, p1, pc
    torch.cuda.reset_peak_memory_stats()
    state = (params, opt.adamw_init(params, ocfg))
    del params
    secs, metrics = [], []
    for gb in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(*state, gb)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        state = (p, o)
    peak = torch.cuda.max_memory_allocated()
    finite = all(np.isfinite(v) for m in metrics for v in m.values())
    if not finite and not vs["fault5"]:
        raise AssertionError(f"{arch} {shape}: non-finite steps {metrics}")
    out = dict(arch=arch, shape=shape, params=n_params, remat=cfg.remat,
               step_s=secs, ms_per_step=float(np.median(secs[1:])) * 1e3,
               peak_bytes=peak, losses=[m["loss"] for m in metrics],
               grad_norms=[m["grad_norm"] for m in metrics],
               cpu_step_s=cpu_s, card_vs_cpu=vs)
    if arch == "dimenet":
        out["basis"] = cs.dimenet_basis_card_vs_cpu(
            cut[1], cfg, device, f"{arch} {shape} cut batch")
    cs.log(f"[tooling] 4e-d {arch} {shape}: {out['ms_per_step']!r} ms/step "
           f"(median after the first, {secs[0] * 1e3!r} ms), peak "
           f"{peak / 1e9!r} GB, {n_params} parameters, losses "
           f"{out['losses']}; the cut batch's CPU step {cpu_s:.2f} s; card "
           "vs CPU " + json.dumps(vs))
    del state
    return out


def minibatch_phase(device, steps=None):
    """``minibatch_lg`` on the card: the Reddit-sized graph
    (``gnn_node_classification(232965, 57307946, 602, 41, seed=0,
    with_pos=True)``, 114,615,892 directed edges), its CSR by receiver on
    the card (:func:`csr_by_receiver`), ``steps`` (default
    ``MINIBATCH["steps"]``) batches of 1,024 seeded seeds sampled with
    fanouts (15, 10), the first a warm-up step's, and a cut batch of
    ``MINIBATCH["cpu_seeds"]`` seeds for the CPU check, then
    :func:`minibatch_cell` for GIN, GatedGCN, PNA and DimeNet, in float32
    with TF32 off.  Features, labels and positions stay on the card and
    each batch gathers its rows there."""
    import chip_smoke as cs
    from repro_torch.configs.gnn_common import SHAPES
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.data.synthetic import gnn_node_classification
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sh = SHAPES[MINIBATCH["shape"]]
    n = sh["n_nodes"]
    t0 = time.perf_counter()
    arrays = gnn_node_classification(n, sh["n_edges"] // 2, sh["d_feat"],
                                     sh["n_classes"], seed=MINIBATCH["seed"],
                                     with_pos=True)
    gen_s = time.perf_counter() - t0
    n_edges = int(arrays["senders"].shape[0])
    if n_edges != sh["n_edges"]:
        raise AssertionError(f"minibatch_lg: {n_edges} directed edges, not "
                             f"{sh['n_edges']}")
    cs.sync(device)
    t0 = time.perf_counter()
    row_ptr, col = csr_by_receiver(arrays.pop("senders"),
                                   arrays.pop("receivers"), n, device)
    csr_s = time.perf_counter() - t0
    data = {k: torch.from_numpy(arrays[k]).to(device)
            for k in ("node_feat", "labels", "pos")}
    cpu_data = {k: torch.from_numpy(arrays[k])
                for k in ("node_feat", "labels", "pos")}
    sampler = NeighborSampler(row_ptr, col, sh["fanout"],
                              seed=MINIBATCH["seed"])
    rng = np.random.default_rng(MINIBATCH["seed"])
    batches, infos = [], []
    for _ in range(steps or MINIBATCH["steps"]):
        gb, info = sampled_batch(data, sampler, rng.choice(
            n, sh["batch_nodes"], replace=False), device)
        batches.append(gb)
        infos.append(info)
    cut_cpu, cut_info = sampled_batch(cpu_data, sampler, rng.choice(
        n, MINIBATCH["cpu_seeds"], replace=False), "cpu")
    cut = (cut_cpu.to(device), cut_cpu)
    del data
    head = dict(nodes=n, directed_edges=n_edges, generate_s=gen_s,
                csr_s=csr_s, batches=infos, cut_batch=cut_info)
    cs.log(f"[tooling] 4e-d minibatch_lg: graph {n} nodes, {n_edges} "
           f"directed edges generated in {gen_s:.2f} s, CSR by receiver on "
           f"the card {csr_s:.2f} s; batches " + json.dumps(infos)
           + "; cut batch " + json.dumps(cut_info))
    cells = [minibatch_cell(arch, batches, cut, device)
             for arch in cs.GNN_ARCHS]
    del batches, cut
    cs.release_card("after phase 4e-d")
    return dict(head, cells=cells)


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
