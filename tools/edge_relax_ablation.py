"""Where an ``edge_relax`` call spends its time on the card, and which
grid the fused kernel runs best on.

    python3 tools/edge_relax_ablation.py

Builds copies of ``src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu``
with one part of the round taken out or changed (``ABLATIONS``), and
copies of ``edge_relax_fused.cu`` with another grid rule
(``FUSED_GRIDS``); each text must occur in its source exactly once, else
the script stops, so an edit to a kernel shows here at once.  Each copy
is timed in place of the real kernel by CUDA-graph replay
(``chip_smoke.graph_ms``) in one pass: the kernel, each copy, the kernel
again; the one-round copies at the mid-solve window of
``chip_smoke.py``'s two graphs (``chip_smoke.window_inputs``), the fused
ones at the smoke's fused tree window (``chip_smoke.fused_window_inputs``,
4 rounds), and the fused kernel alone there capped at 1, 2 and 4
rounds and with no frontier (``[fused rounds]``).  The ablated copies'
outputs are wrong by design and are not checked; the grid copies'
outputs must equal the kernel's bit for bit.  Every copy leaves the
scratch as it found it.  Prints the card's name and power limit, then
``[ablation]``, ``[fused grid]`` and ``[fused rounds]`` JSON lines per
graph.  Needs one card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402

# name: (text of edge_relax.cu, what takes its place)
ABLATIONS = {
    # plain stores to the same keys
    "store": ("atomicMin(&keys[d], pack_key(c, s));",
              "keys[d] = pack_key(c, s);"),
    # the same atomics on distinct keys (no contention on hub destinations)
    "spread": ("atomicMin(&keys[d], pack_key(c, s));",
               "atomicMin(&keys[e & 0xFFFFF], pack_key(c, s));"),
    "no-atomic": ("atomicMin(&keys[d], pack_key(c, s));", ";"),
    "no-dist": ("__fadd_rn(dist[s], w[e]);", "__fadd_rn(lb, w[e]);"),
    "no-parent": ("d != parent[s];", "d != s;"),
    # the schedule and the flags' clearing, no slot read
    "schedule-only": ("const int64_t base = (int64_t)t * tile_e;",
                      "const int64_t base = (int64_t)t * tile_e;\n"
                      "    if (base >= 0) continue;"),
    # only the forced tiles scheduled: the call's fixed cost
    "forced-only": ("if (s < n_src && paths[s]) {", "if (s < 0) {"),
}

# name: (text of edge_relax_fused.cu, what takes its place)
FUSED_GRIDS = {
    # one block per SM in place of the co-resident maximum
    "one-block-per-SM": (
        "const int blocks =\n"
        "      alt ? resident_blocks<fused_rounds_kernel<true>>(kThreads)\n"
        "          : resident_blocks<fused_rounds_kernel<false>>(kThreads);",
        "int dev = 0, blocks = 0;\n"
        "  cudaGetDevice(&dev);\n"
        "  cudaDeviceGetAttribute(&blocks, cudaDevAttrMultiProcessorCount,"
        " dev);"),
}


def build_copies(source: str, variants: dict, entry: str, argtypes):
    """Build every copy of ``csrc/<source>.cu`` in ``variants`` (one
    ``nvcc`` each, all at once) into ``build/edge_relax_ablation/``;
    returns ``{name: <entry>}``."""
    from repro_torch.kernels import _build
    path = _build.sources()[source]
    text = path.read_text()
    out = _build.BUILD_DIR.parent / "edge_relax_ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in variants.items():
        if text.count(old) != 1:
            raise AssertionError(f"copy {name}: {old!r} is not in "
                                 f"{path.name} exactly once")
        src = out / f"{name}.cu"
        src.write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(path.parent),
             "-o", str(out / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for copy {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / f"{name}.so")), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def in_place_of(ops, fns, call, check=None):
    """``call`` timed by CUDA-graph replay with the real kernel, with each
    copy in ``fns`` in its place, and with the real kernel again; with
    ``check``, each copy's output must pass ``check(output)``."""
    real = ops._library
    times = {"kernel": chip_smoke.graph_ms(call)}
    try:
        for variant, fn in fns.items():
            ops._library = lambda *a, _fn=fn, **k: _fn
            if check is not None:
                check(call())
            times[variant] = chip_smoke.graph_ms(call)
    finally:
        ops._library = real
    times["kernel again"] = chip_smoke.graph_ms(call)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("edge_relax_ablation: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.core.graph import build_blocked
    from repro_torch.core.sssp import sssp
    from repro_torch.data.generators import kronecker, road_grid
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import ops
    device = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    _build.build_all()
    fns = build_copies("edge_relax", ABLATIONS, "edge_relax_launch",
                       ops._ROUND_ARGTYPES)
    grids = build_copies("edge_relax_fused", FUSED_GRIDS,
                         "edge_relax_fused_launch", ops._FUSED_ARGTYPES)
    for name, hg in (("kronecker(20,16)", kronecker(**chip_smoke.KRON)),
                     ("road_grid(1024)", road_grid(**chip_smoke.ROAD))):
        dg = hg.to_device(device)
        bg = build_blocked(dg)
        dist, parent, _ = sssp(dg, int(np.argmax(hg.deg)),
                               backend="blocked", layout=bg, device=device)
        res = dict(graph=dg, layout=bg, dist=dist, parent=parent)
        args, kw = chip_smoke.window_inputs(res, device)
        if kw["n_out"] < 1 << 20:
            raise AssertionError("the spread ablation needs 2^20 keys")
        times = in_place_of(ops, fns, lambda: ops.relax_bucket(*args, **kw))
        print(f"[ablation] {name} edge_relax: " + json.dumps(times),
              flush=True)
        fargs = chip_smoke.fused_window_inputs(res, device)
        fkw = dict(tile_e=bg.tile_e, fused_rounds=chip_smoke.FUSED_ROUNDS,
                   index=bg.index)
        call = lambda: ops.relax_fused(*fargs, **fkw)
        want = call()

        def same(out):
            if not (chip_smoke.bitwise_equal(out[0], want[0]) and all(
                    a.equal(b) for a, b in zip(out[1:], want[1:]))):
                raise AssertionError(f"{name}: a grid copy of "
                                     "edge_relax_fused disagrees")
        times = in_place_of(ops, grids, call, same)
        print(f"[fused grid] {name} edge_relax_fused at the tree window, "
              f"{want[3].tolist()}: " + json.dumps(times), flush=True)
        # the kernel's cost by rounds: the same call capped at 1 and 2
        # rounds, and with no frontier (one round of the forced tiles:
        # the launch, the pass over the vertices and two barriers)
        empty = (*fargs[:2], torch.zeros_like(fargs[2]), *fargs[3:])
        rounds = {f"{r} rounds": chip_smoke.graph_ms(
            lambda r=r: ops.relax_fused(*fargs, **dict(fkw, fused_rounds=r)))
            for r in (1, 2, chip_smoke.FUSED_ROUNDS)}
        rounds["no frontier"] = chip_smoke.graph_ms(
            lambda: ops.relax_fused(*empty, **fkw))
        print(f"[fused rounds] {name} edge_relax_fused: "
              + json.dumps(rounds), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
