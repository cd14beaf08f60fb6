"""Where an ``edge_relax`` call over slots spends its time on the card.

    python3 tools/relax_batch_ablation.py

Builds copies of ``src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu``
with one part of the batched round (``relax_union``) taken out or changed
(``ABLATIONS``; each text must occur in the source exactly once, else the
script stops) and times each in place of the real kernel by CUDA-graph
replay (``chip_smoke.graph_ms``) in one pass: the kernel, each copy, the
kernel again.  The call is the middle ``edge_relax_batch`` call of
``chip_smoke.py``'s batched tree spec on kronecker(20,16): 8 sources,
the max-degree one and 7 seeded as phase 3c picks them.  The ablated
copies' outputs are wrong by design and are not checked, but for those
in ``EXACT``, whose outputs must equal the kernel's bit for bit.  Then
``[batch profile]`` lines: the device ms of each kernel of the batched
call (``torch.profiler``, the mean of 10 calls) beside the same slots'
one-state calls, for the heaviest slot alone, the three heaviest and
all 8.  Prints the card's name and power limit first.  Needs one card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
from edge_relax_ablation import build_copies, in_place_of  # noqa: E402

_ATOMIC = "atomicMin(&keys[kd], pack_key(c, s));"
# name: (text of edge_relax.cu, what takes its place)
ABLATIONS = {
    # a read of the key first, the atomicMin only for a candidate below it
    "read-filter": (_ATOMIC, "{ const unsigned long long key = "
                    "pack_key(c, s); if (key < __ldcg(&keys[kd])) "
                    "atomicMin(&keys[kd], key); }"),
    # plain stores to the same keys
    "store": (_ATOMIC, "keys[kd] = pack_key(c, s);"),
    # the same atomics on distinct keys of the slot's row (no contention
    # on hub destinations)
    "spread": (_ATOMIC, "atomicMin(&keys[kd - d + (e & 0xFFFFF)], "
               "pack_key(c, s));"),
    "no-atomic": (_ATOMIC, ";"),
    # the schedule, the list, the tiles' walk and the unpack: no slot read
    "schedule-only": ("for (int i = tid; i < tile_e; i += blockDim.x) {\n"
                      "      const int64_t e = base + i;\n"
                      "      const int32_t s = src[e];\n"
                      "      // the slots of the mask in turn;",
                      "for (int i = tile_e; i < tile_e; i += blockDim.x) {\n"
                      "      const int64_t e = base + i;\n"
                      "      const int32_t s = src[e];\n"
                      "      // the slots of the mask in turn;"),
    # only the forced tiles scheduled: the launches and the unpack
    "forced-only": ("if (g < n_group && s < n_src && paths[group[g] * "
                    "n_src + s]) {", "if (s < 0) {"),
}
# the copies whose output must equal the kernel's bit for bit
EXACT = ("read-filter",)


def schedule_sizes(args, kw) -> dict:
    """The union of the active slots' scheduled tiles, and each slot's
    tiles and slots whose source has a path, from ``schedule_tiles``."""
    from repro_torch.kernels.edge_relax import ref
    dist, paths, parent, src, dst, w, tile_first, *_ = args
    tile_e = kw["tile_e"]
    union = torch.zeros(tile_first.shape[0], dtype=torch.bool,
                        device=src.device)
    per_slot = []
    for i in kw["active"].tolist():
        sched, n = ref.schedule_tiles(paths[i], src, w, tile_first, tile_e)
        tiles = sched[:int(n)].long()
        union[tiles] = True
        slots = (tiles[:, None] * tile_e + torch.arange(
            tile_e, device=src.device)[None, :]).reshape(-1)
        per_slot.append([int(n), int(paths[i][src[slots].long()].sum())])
    return dict(union_tiles=int(union.sum()), n_tiles=tile_first.shape[0],
                tiles_and_path_slots=per_slot)


def kernel_ms(fn, reps: int = 10) -> dict:
    """Device ms of each CUDA kernel ``fn()`` launches, the mean over
    ``reps`` calls (``torch.profiler``, after 3 warm-up calls)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", 0) / reps / 1e3
        if ms > 0 and "anonymous namespace" in e.key:
            out[e.key.split("::")[1].split("(")[0]] = ms
    return out


def profiles(args, kw, counts) -> None:
    """``[batch profile]`` lines for the heaviest slot (by scheduled
    tiles), the three heaviest and every active slot."""
    from repro_torch.kernels.edge_relax import ops
    dist, paths, parent, src, dst, w, tile_first, lb, ub = args
    rkw = dict(tile_e=kw["tile_e"], n_out=kw["n_out"], index=kw["index"])
    active = kw["active"].tolist()
    by_tiles = sorted(active, key=lambda i: -counts[active.index(i)][2])
    for slots in (by_tiles[:1], sorted(by_tiles[:3]), active):
        act = torch.tensor(slots, dtype=torch.int32, device=dist.device)
        batch = kernel_ms(lambda: ops.relax_bucket(*args, **dict(
            kw, active=act)))

        def singles():
            for i in slots:
                ops.relax_bucket(dist[i], paths[i], parent[i], src, dst, w,
                                 tile_first, lb[i], ub[i], **rkw)
        print(f"[batch profile] slots {slots}: " + json.dumps(dict(
            batch=batch, singles=kernel_ms(singles))), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("relax_batch_ablation: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.api import EngineConfig, SolveSpec, Solver
    from repro_torch.core.graph import build_blocked
    from repro_torch.data.generators import kronecker
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import ops
    device = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    _build.build_all()
    fns = build_copies("edge_relax", ABLATIONS, "edge_relax_batch_launch",
                       ops._BATCH_ARGTYPES)
    hg = kronecker(**chip_smoke.KRON)
    dg = hg.to_device(device)
    bg = build_blocked(dg)
    if bg.n_out < 1 << 20:
        raise AssertionError("the spread ablation needs 2^20 keys a slot")
    source = int(np.argmax(hg.deg))
    rng = np.random.default_rng(31)          # phase 3c's sources
    nz = np.flatnonzero(hg.deg > 0)
    srcs = [source] + [int(v) for v in rng.choice(
        nz[nz != source], chip_smoke.FACADE_SLOTS - 1, replace=False)]
    solver = Solver.open(dg, EngineConfig(backend="blocked"), layout=bg,
                         device=device)
    spec = SolveSpec.tree(srcs)
    ops.LAUNCHES.reset()
    solver.solve(spec)
    args, kw = chip_smoke.mid_batch_call(solver, spec,
                                         ops.LAUNCHES.edge_relax_batch)
    call = lambda: ops.relax_bucket(*args, **kw)
    want = call()
    active = kw["active"].tolist()

    def same(out):
        if not all(chip_smoke.bitwise_equal(out[0][i], want[0][i])
                   and out[1][i].equal(want[1][i])
                   and out[2][i].equal(want[2][i]) for i in active):
            raise AssertionError("an exact copy disagrees with the kernel")
    exact = in_place_of(ops, {n: fns.pop(n) for n in EXACT}, call, same)
    times = in_place_of(ops, fns, call)
    times["kernel (exact pass)"] = [exact.pop("kernel"),
                                    exact.pop("kernel again")]
    times.update(exact)
    times["counts"] = [want[2][i].tolist() for i in active]
    times.update(schedule_sizes(args, kw))
    print("[batch ablation] kronecker(20,16) edge_relax_batch at the "
          "batched tree spec's middle call: " + json.dumps(times),
          flush=True)
    profiles(args, kw, times["counts"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
