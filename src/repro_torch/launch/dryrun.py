"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step, the
port's copy of ``repro.launch.dryrun``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sssp --mesh both \\
        [--sssp-version v1|v2|v3|all] [--backend segment_min|blocked]

The reference compiles each cell ahead of time for 512 placeholder XLA
devices.  Torch has no ahead-of-time SPMD compiler; here the process
starts a ``"fake"`` process group of 256 (``single``) or 512
(``multi``) ranks, as rank 0, and traces each cell's step once on
``meta`` DTensors (``launch/cells.py``): forward and, for train cells,
backward and the AdamW update.  Each artifact holds the cell's ``meta``,
``arg_bytes_per_device`` (rank 0's shards of the arguments),
``collectives`` (what the traced step issued on rank 0, by kind:
``launch/comm_stats.py``; DTensor's redistributions are not XLA's
partitioner's, so these bytes are the port's own), ``cost.flops`` (rank
0's FLOPs, ``torch.utils.flop_counter``'s formulas), ``timing.trace_s``
and ``memory: {"available": false}``: there is no compiler memory
analysis to report.

``--sssp`` runs the distributed SSSP engine's round on rank 0's shard of
a Graph500-scale graph (``run_sssp``): the shard only, built from a
seed on the card (``--device cpu`` to stay on the CPU), one relaxation
round and one step transition of v1, v2 or v3 with the fake group's
collectives, which move nothing; it records the collective bytes of the
iteration and its device seconds.

Artifacts go to ``--out`` (default ``artifacts/dryrun_torch/<mesh>/``,
under the working directory).  Completed cells are skipped on re-runs
unless ``--force``.  The exit code is 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ART_DIR = os.path.join("artifacts", "dryrun_torch")
WORLD = {"single": 256, "multi": 512}
MEMORY_NOTE = ("torch has no ahead-of-time SPMD compiler: no memory "
               "analysis of a compiled step exists to report")


def start_fake_group(world: int):
    """Make this process rank 0 of a ``"fake"`` process group of
    ``world`` ranks (collectives move nothing); an existing group of that
    size is kept, another size is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def _mesh(mesh_kind: str):
    from .mesh import make_production_mesh
    start_fake_group(WORLD[mesh_kind])
    return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type="cpu")


def _leaves(tree):
    from ..models.gnn.common import GraphBatch
    from ..train.tree import leaves
    if isinstance(tree, GraphBatch):
        import dataclasses
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), torch.Tensor)]
    if isinstance(tree, (list, tuple)) and any(
            isinstance(t, GraphBatch) for t in tree):
        return [x for t in tree for x in _leaves(t)]
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def arg_bytes_per_device(args) -> int:
    """Rank 0's bytes of every argument leaf (a DTensor's local shard)."""
    from ..parallel.dtensor_ops import is_dtensor
    total = 0
    for leaf in _leaves(args):
        t = leaf.to_local() if is_dtensor(leaf) else leaf
        total += t.numel() * t.element_size()
    return total


def _settle(out):
    """Every DTensor of ``out`` with a pending (partial) sum reduced: an
    output is materialized, as XLA's step returns it."""
    from torch.distributed.tensor import Replicate
    from ..parallel.dtensor_ops import is_dtensor
    if is_dtensor(out):
        if any(p.is_partial() for p in out.placements):
            return out.redistribute(out.device_mesh, tuple(
                Replicate() if p.is_partial() else p
                for p in out.placements))
        return out
    if isinstance(out, dict):
        return {k: _settle(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_settle(v) for v in out)
    return out


def _redistribute_out(out, places):
    """The outputs redistributed to ``places`` (the reference's
    ``out_shardings``), leaf by leaf where both are given; partial sums
    reduced."""
    from ..parallel.dtensor_ops import constrain
    if places is None or out is None:
        return _settle(out)
    if isinstance(out, torch.Tensor):
        return _settle(constrain(out, places))
    if isinstance(out, dict) and isinstance(places, dict):
        return {k: _redistribute_out(v, places.get(k)) for k, v in
                out.items()}
    if isinstance(out, (list, tuple)) and isinstance(places, (list, tuple)) \
            and len(out) == len(places):
        return type(out)(_redistribute_out(o, p) for o, p in
                         zip(out, places))
    return _settle(out)


def trace_cell(fn, args, out_places=None):
    """Run ``fn(*args)`` once on this rank with the DTensor fallbacks,
    recording its collectives and FLOPs.  Returns ``(out, records,
    flops, seconds, replicated)``: ``replicated`` names the operators
    that ran replicated, having no DTensor strategy that worked."""
    from ..parallel.dtensor_ops import replicate_fallback
    from .comm_stats import CommRecorder, LocalFlops

    t0 = time.perf_counter()
    with replicate_fallback() as replicated, CommRecorder() as rec, \
            LocalFlops() as fl:
        out = fn(*args)
        out = _redistribute_out(out, out_places)
        replicated = sorted(replicated)
    return out, rec.records, fl.flops, time.perf_counter() - t0, replicated


def _art_path(out_dir, mesh_kind, name):
    os.makedirs(os.path.join(out_dir, mesh_kind), exist_ok=True)
    return os.path.join(out_dir, mesh_kind, f"{name}.json")


def _cached(path, force, label):
    if os.path.exists(path) and not force:
        with open(path) as f:
            art = json.load(f)
        if art.get("ok"):
            print(f"[skip] {label} (cached)")
            return art
    return None


def run_cell(arch: str, shape: str, mesh_kind: str, force: bool = False,
             out_dir: str = ART_DIR):
    from . import cells
    from .comm_stats import collective_bytes

    path = _art_path(out_dir, mesh_kind, f"{arch}__{shape}")
    art = _cached(path, force, f"{mesh_kind}/{arch}/{shape}")
    if art is not None:
        return art
    t0 = time.perf_counter()
    art = {"arch": arch, "shape": shape, "mesh": mesh_kind, "ok": False}
    try:
        mesh = _mesh(mesh_kind)
        art["mesh_shape"] = dict(zip(mesh.mesh_dim_names,
                                     (int(s) for s in mesh.shape)))
        fn, args, meta, out_places = cells.build_cell(arch, shape, mesh)
        art["meta"] = {k: (int(v) if isinstance(v, int) else v)
                       for k, v in meta.items()}
        art["arg_bytes_per_device"] = arg_bytes_per_device(args)
        t_build = time.perf_counter() - t0
        _, records, flops, t_trace, replicated = trace_cell(fn, args,
                                                           out_places)
        art["cost"] = {"flops": float(flops)}
        art["replicated_ops"] = replicated
        art["memory"] = {"available": False, "why": MEMORY_NOTE}
        art["collectives"] = collective_bytes(records)
        art["timing"] = {"build_s": round(t_build, 3),
                         "trace_s": round(t_trace, 3)}
        art["ok"] = True
        c = art["collectives"]
        print(f"[ok] {mesh_kind}/{arch}/{shape}: flops/dev={flops:.3e} "
              f"coll={c['total'] / 1e9:.3f}GB {c['counts']} "
              f"trace={t_trace:.1f}s", flush=True)
    except Exception as e:  # noqa: BLE001 - record failures in the artifact
        art["error"] = f"{type(e).__name__}: {e}"[:2000]
        art["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {mesh_kind}/{arch}/{shape}: {art['error'][:500]}",
              flush=True)
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    return art


# --- SSSP --------------------------------------------------------------------

RMAT = (0.57, 0.19, 0.19)          # Graph500's a, b, c


def _rmat_bits(gen, m: int, bits: int, dev, row: bool):
    """``m`` R-MAT endpoints of ``bits`` bits: the row (source) or the
    column (destination) coordinate of Graph500's recursive quadrants."""
    a, b, c = RMAT
    out = torch.zeros(m, dtype=torch.int64, device=dev)
    for bit in range(bits):
        r = torch.rand(m, generator=gen, device=dev)
        # P(row bit) = c + d; P(col bit) = b + d
        p = (1.0 - a - b) if row else (1.0 - a - c)
        out |= (r < p).to(torch.int64) << bit
    return out


def rank0_shard(scale: int, edge_factor: int, world: int, *, device):
    """Rank 0's shard of a Graph500-scale graph, and nothing of the
    other ranks': ``2 * edge_factor * 2^scale / world`` directed edges
    whose sources are R-MAT-drawn within the owner block ``[0, n /
    world)`` and whose destinations are R-MAT-drawn over all ``n``
    vertices and scattered by a seeded permutation, weights uniform in
    ``(0, 1]``, built from seed 0 on ``device``.  Returns a dict of
    ``src``, ``dst`` (int64), ``w`` (f32), ``deg`` (int32, the block's),
    ``rtow`` and the sizes."""
    from ..core.graph import RATIO_NUM

    dev = torch.device(device)
    n = 1 << scale
    if n % world:
        raise ValueError(f"2^{scale} vertices do not split over {world}")
    block = n // world
    e_max = 2 * edge_factor * n // world
    gen = torch.Generator(device=dev).manual_seed(0)
    src = _rmat_bits(gen, e_max, int(math.log2(block)), dev, True)
    dst = _rmat_bits(gen, e_max, scale, dev, False)
    perm = torch.randperm(n, generator=gen, device=dev)
    dst = perm[dst]
    w = 1.0 - torch.rand(e_max, generator=gen, device=dev)
    order = torch.argsort(src * n + dst)
    src, dst, w = src[order], dst[order], w[order]
    deg = torch.bincount(src, minlength=block).to(torch.int32)
    qs = torch.linspace(0.0, 1.0, RATIO_NUM, device=dev,
                        dtype=torch.float64)
    rtow = torch.quantile(w.double(), qs).to(torch.float32)
    return {"src": src, "dst": dst, "w": w, "deg": deg, "rtow": rtow,
            "n": n, "block": block, "e_max": e_max,
            "n_edges2": 2 * edge_factor * n}


def _rank0_slabs(shard, world: int, dev):
    """Rank 0's blocked slabs of :func:`rank0_shard` (the layout of
    ``core.distributed.shard_blocked`` for shard 0, built on the host from
    this shard alone) on ``dev``."""
    from types import SimpleNamespace
    import numpy as np
    from ..core.distributed import _DeviceSlabs
    from ..core.graph import TileIndex, shard_block_v, shard_geometry, \
        slice_for_shard

    block = shard["block"]
    bv, tile_e = shard_geometry(block, dev)
    bv = shard_block_v(block, bv)
    deg = np.zeros(shard["n"], np.int32)
    deg[:block] = shard["deg"].cpu().numpy()
    g = SimpleNamespace(src=shard["src"].cpu().numpy(),
                        dst=shard["dst"].cpu().numpy(),
                        w=shard["w"].cpu().numpy(), deg=deg)
    sl = slice_for_shard(g, 0, world, block_v=bv, tile_e=tile_e)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return _DeviceSlabs(
        src=t(sl.src), dst=t(sl.dst), w=t(sl.w), tile_first=t(sl.tile_first),
        index=TileIndex(t(sl.index.vt_ptr), t(sl.index.vt_tile),
                        t(sl.index.forced)),
        base=0, block=block, tile_e=sl.tile_e,
        dense_grid_tiles=sl.dense_grid_tiles)


class _Mirror(TorchDispatchMode):
    """The fake group's collectives move nothing and may leave their
    outputs as allocated.  Under this mode each output is filled as if
    every rank held rank 0's data: a reduce-scatter hands rank 0 its own
    block of its input, an all-gather repeats the input, an all-to-all
    returns it; an all-reduce keeps rank 0's value.  So the iteration
    reads defined values (indices stay in range) on any device.  While
    ``keep`` is set, a copy of every int64 tensor a collective sends
    (the packed (value, winner) keys of the exchanges) goes to
    ``sent``."""

    def __init__(self):
        super().__init__()
        self.keep, self.sent = False, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket._qualified_op_name
        if self.keep and name.startswith("c10d::"):
            sent = args[0] if name == "c10d::allreduce_" else args[1:2]
            self.sent += [t.clone() for t in sent
                          if isinstance(t, torch.Tensor) and
                          t.dtype == torch.int64]
        out = func(*args, **(kwargs or {}))
        if name == "c10d::_reduce_scatter_base_":
            args[0].copy_(args[1].reshape(-1)[:args[0].numel()]
                          .view_as(args[0]))
        elif name == "c10d::_allgather_base_":
            args[0].view(-1, args[1].numel()).copy_(args[1].reshape(1, -1))
        elif name == "c10d::alltoall_base_":
            args[0].copy_(args[1])
        return out

    def sends_of(self, fn):
        """``fn()`` and the int64 tensors its collectives sent."""
        self.keep, self.sent = True, []
        try:
            return fn(), self.sent
        finally:
            self.keep, self.sent = False, []


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _check_vs_plain(mirror, relax, slabs) -> int:
    """The blocked round (``edge_relax_partials``) against the plain
    round (``segment_min``) from the same state: every exchange's packed
    keys (all ``n`` destinations' values and winners, before any rank's
    block is cut out) and the round's state (``dist``, ``parent``,
    ``frontier``, the logical counters) equal bit for bit; raises on the
    first difference.  Returns the number of keys compared."""
    from ..core.sssp import LOGICAL_METRIC_FIELDS

    (s_k, sent_k), (s_p, sent_p) = (mirror.sends_of(lambda: relax(sl))
                                    for sl in (slabs, None))
    if [t.shape for t in sent_k] != [t.shape for t in sent_p] or any(
            not torch.equal(a, b) for a, b in zip(sent_k, sent_p)):
        raise RuntimeError("edge_relax_partials: the exchanged keys differ "
                           "from the plain round's")
    for f in ("dist", "parent", "frontier"):
        if not torch.equal(_bits(getattr(s_k, f)), _bits(getattr(s_p, f))):
            raise RuntimeError(f"edge_relax_partials: the round's {f} "
                               "differs from the plain round's")
    for f in LOGICAL_METRIC_FIELDS:
        if not torch.equal(getattr(s_k.metrics, f), getattr(s_p.metrics, f)):
            raise RuntimeError(f"edge_relax_partials: the round's {f} "
                               "differs from the plain round's")
    return sum(t.numel() for t in sent_k)


class _Clock:
    """Device seconds of a call: CUDA events on a card, else the host's
    clock around a call."""

    def __init__(self, dev):
        self.cuda = torch.device(dev).type == "cuda"

    def __call__(self, fn):
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            return out, a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0


def sssp_iteration(shard, version: str, world: int, dev, slabs=None):
    """One relaxation round and one step transition of ``version`` on
    rank 0's ``shard`` over the default (fake) group (:class:`_Mirror`
    fills the collectives' outputs), from the block's vertex of the
    largest degree not above v3's exchange capacity, timed after an
    untimed warm-up iteration.  With ``slabs`` (the blocked backend) the
    round is then held against the plain one (:func:`_check_vs_plain`).
    Returns a dict of the round's and the transition's collective
    records, their device seconds, the round's ``n_relax`` on rank 0,
    the ``edge_relax_partials`` launches of both iterations and the
    number of keys held against the plain round."""
    import torch.distributed as tdist
    from ..core import distributed as D
    from ..core import sssp as single
    from ..core.graph import degree_bucket
    from ..core.stepping import SteppingParams
    from ..kernels.edge_relax.ops import LAUNCHES
    from .comm_stats import CommRecorder

    block, n = shard["block"], shard["n"]
    group = tdist.group.WORLD
    n_edges2 = torch.tensor(shard["n_edges2"], dtype=torch.int64,
                            device=dev)
    # the block's vertex of the largest degree within v3's capacity: its
    # candidates fit v3's compacted exchange, and every version relaxes
    # the same edges
    deg = shard["deg"]
    cap = D._default_capacity(block)
    source = int(torch.argmax(torch.where(deg <= cap, deg, 0)))
    clock = _Clock(dev)
    alpha, beta = SteppingParams().alpha, SteppingParams().beta
    if version == "v1":
        deg = torch.zeros(n, dtype=torch.int32, device=dev)
        deg[:block] = shard["deg"]
        view = D._ShardView(src=shard["src"], dst=shard["dst"], w=shard["w"],
                            deg=deg, rtow=shard["rtow"], n_edges2=n_edges2,
                            group=group)
        c = single._consts(view.deg, alpha, beta)
        s0 = single._initial_state(n, source, dev)
        relax = lambda sl: D._v1_relax_round(view, sl, s0)
        transition = lambda s: single._transition(
            view, s, c, min_pending=D._v1_min_pending,
            pull_phase=D._v1_pull_phase)
    else:
        v = D._LocalView(src=shard["src"], src_l=shard["src"],
                         dst=shard["dst"], w=shard["w"], deg=shard["deg"],
                         bucket=degree_bucket(shard["deg"]),
                         rtow=shard["rtow"], n_edges2=n_edges2, group=group,
                         rank=0, world=world, block=block)
        cap = D._default_capacity(block) if version == "v3" else 0
        ex = D._Exchange(v, cap)
        c = D._v2_consts(v, alpha, beta)
        s0 = D._v2_initial_state(v, source, dev)
        relax = lambda sl: D._v2_round(v, sl, s0, ex)[0]
        transition = lambda s: D._v2_transition(
            v, s, c, ex, "tree",
            torch.zeros((), dtype=torch.int32, device=dev))
    launches0 = LAUNCHES.edge_relax_partials
    with _Mirror() as mirror:
        # a warm-up iteration first (allocations, the kernel's first
        # launch); both iterations start from the same initial state
        transition(relax(slabs))
        with CommRecorder() as rec_r:
            s, t_round = clock(lambda: relax(slabs))
        with CommRecorder() as rec_t:
            _, t_trans = clock(lambda: transition(s))
        launches = LAUNCHES.edge_relax_partials - launches0
        checked = 0 if slabs is None else _check_vs_plain(mirror, relax,
                                                          slabs)
    return {"round": rec_r.records, "transition": rec_t.records,
            "round_s": t_round, "transition_s": t_trans,
            "n_relax": int(s.metrics.n_relax), "source": source,
            "launches": launches, "keys_vs_plain": checked}


def run_sssp(mesh_kind: str, scale: int = 26, edge_factor: int = 16,
             version: str = "v2", backend: str = "segment_min",
             device=None, force: bool = False, out_dir: str = ART_DIR,
             shard=None, world=None):
    """Dry-run one iteration of the distributed SSSP engine on rank 0's
    shard of a Graph500-scale graph (``--sssp``).  ``device=None`` means
    the card (and raises without one); ``shard`` reuses a
    :func:`rank0_shard` of the same sizes (and its blocked slabs, kept
    in it under ``"slabs"`` once built); ``world`` overrides the mesh's
    rank count (256 or 512)."""
    from ..core.sssp import resolve_device
    from .comm_stats import collective_bytes

    name = f"sssp-{version}-{backend}-gr{scale}_{edge_factor}"
    path = _art_path(out_dir, mesh_kind, name)
    art = _cached(path, force, f"{mesh_kind}/{name}")
    if art is not None:
        return art
    world = WORLD[mesh_kind] if world is None else int(world)
    art = {"arch": name, "shape": f"n=2^{scale},ef={edge_factor}",
           "mesh": mesh_kind, "world": world, "backend": backend,
           "ok": False}
    t0 = time.perf_counter()
    try:
        dev = resolve_device(device)
        start_fake_group(world)
        if shard is None:
            shard = rank0_shard(scale, edge_factor, world, device=dev)
        t_shard = time.perf_counter() - t0
        if backend == "blocked" and "slabs" not in shard:
            shard["slabs"] = _rank0_slabs(shard, world, dev)
        slabs = shard.get("slabs") if backend == "blocked" else None
        t_build = time.perf_counter() - t0
        it = sssp_iteration(shard, version, world, dev, slabs)
        art["rank0"] = {"block": shard["block"], "edges": shard["e_max"],
                        "source": it["source"], "n_relax": it["n_relax"],
                        "edge_relax_partials_launches": it["launches"],
                        "keys_vs_plain": it["keys_vs_plain"]}
        if backend == "blocked" and dev.type == "cuda" and \
                it["launches"] <= 0:
            raise RuntimeError("the blocked round launched no "
                               "edge_relax_partials")
        art["collectives"] = collective_bytes(it["round"] +
                                              it["transition"])
        art["collectives_round"] = collective_bytes(it["round"])
        art["collectives_transition"] = collective_bytes(it["transition"])
        art["device_s"] = {"round": it["round_s"],
                           "transition": it["transition_s"]}
        art["memory"] = {"available": False, "why": MEMORY_NOTE}
        art["note"] = ("collectives are one iteration's (one round and one "
                       "transition) on rank 0; the fake group moves no "
                       "data, so values after the first exchange are not "
                       "a solve's")
        art["timing"] = {"shard_s": round(t_shard, 3),
                         "layout_s": round(t_build - t_shard, 3),
                         "total_s": round(time.perf_counter() - t0, 3)}
        if it["n_relax"] <= 0:
            raise RuntimeError("rank 0's round relaxed no edge")
        art["ok"] = True
        c = art["collectives"]
        print(f"[ok] {mesh_kind}/{name}: coll/iter={c['total'] / 1e6:.1f}MB "
              f"{c['per_op']} round={it['round_s'] * 1e3:.3f}ms "
              f"transition={it['transition_s'] * 1e3:.3f}ms "
              f"n_relax={it['n_relax']} shard={t_shard:.1f}s "
              f"layout={t_build - t_shard:.1f}s "
              f"total={art['timing']['total_s']:.1f}s", flush=True)
    except Exception as e:  # noqa: BLE001
        art["error"] = f"{type(e).__name__}: {e}"[:2000]
        art["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {mesh_kind}/{name}: {art['error'][:500]}", flush=True)
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    art["_shard"] = shard
    return art


def main(argv=None):
    from .. import configs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--cell", action="append", default=[],
                    help="arch/shape, repeatable (with or without --sssp)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-bonus", action="store_true")
    ap.add_argument("--sssp", action="store_true")
    ap.add_argument("--sssp-version", default="v2",
                    choices=["v1", "v2", "v3", "all"])
    ap.add_argument("--backend", default="segment_min",
                    choices=["segment_min", "blocked"])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--device", default=None,
                    help="the SSSP shard's device (default: the card)")
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells_asked = [tuple(c.split("/", 1)) for c in args.cell]
    if args.arch or args.shape:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape go together")
        cells_asked.append((args.arch, args.shape))
    if not (args.sssp or args.all or cells_asked):
        ap.error("--arch/--shape (or --cell) required unless --all or "
                 "--sssp")
    versions = ["v1", "v2", "v3"] if args.sssp_version == "all" \
        else [args.sssp_version]
    results = []
    t0 = time.perf_counter()
    if args.sssp:
        for mk in meshes:
            shard = None
            for ver in versions:
                art = run_sssp(mk, args.scale, version=ver,
                               backend=args.backend, device=args.device,
                               force=args.force, out_dir=args.out,
                               shard=shard)
                shard = art.pop("_shard", None)
                results.append(art)
            del shard
    if args.all:
        cells_asked += list(configs.all_cells(
            include_bonus=args.include_bonus))
    for mk in meshes:
        for arch, shape in cells_asked:
            results.append(run_cell(arch, shape, mk, args.force, args.out))
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n=== dry-run: {n_ok}/{len(results)} cells traced in "
          f"{time.perf_counter() - t0:.1f}s ===", flush=True)
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
