"""Where a one-round ``edge_relax`` call spends its time on the card.

    python3 tools/edge_relax_ablation.py

Builds copies of ``src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu``
with one part of the round taken out or changed (``ABLATIONS``; each text
must occur in the source exactly once, else the script stops, so an edit
to the kernel shows here at once), and times each in place of the real
kernel by CUDA-graph replay (``chip_smoke.graph_ms``) at the mid-solve
window of ``chip_smoke.py``'s two graphs (``chip_smoke.window_inputs``),
in one pass: the kernel, each copy, the kernel again.  The copies'
outputs are wrong by design and are not checked; each leaves the scratch
as it found it.  Prints the card's name and power limit, then one
``[ablation]`` JSON line per graph.  Needs one card.
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


def build_ablations():
    """Build every ``ABLATIONS`` copy (one ``nvcc`` each, all at once)
    into ``build/edge_relax_ablation/``; returns ``{name:
    edge_relax_launch}``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import ops
    text = _build.sources()["edge_relax"].read_text()
    out = _build.BUILD_DIR.parent / "edge_relax_ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in ABLATIONS.items():
        if text.count(old) != 1:
            raise AssertionError(f"ablation {name}: {old!r} is not in "
                                 "edge_relax.cu exactly once")
        src = out / f"{name}.cu"
        src.write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).edge_relax_launch
        fn.argtypes, fn.restype = ops._ROUND_ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


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
    fns = build_ablations()
    real = ops._library
    for name, hg in (("kronecker(20,16)", kronecker(**chip_smoke.KRON)),
                     ("road_grid(1024)", road_grid(**chip_smoke.ROAD))):
        dg = hg.to_device(device)
        bg = build_blocked(dg)
        dist, parent, _ = sssp(dg, int(np.argmax(hg.deg)),
                               backend="blocked", layout=bg, device=device)
        args, kw = chip_smoke.window_inputs(
            dict(graph=dg, layout=bg, dist=dist, parent=parent), device)
        if kw["n_out"] < 1 << 20:
            raise AssertionError("the spread ablation needs 2^20 keys")
        call = lambda: ops.relax_bucket(*args, **kw)
        times = {"kernel": chip_smoke.graph_ms(call)}
        try:
            for variant, fn in fns.items():
                ops._library = lambda *a, _fn=fn, **k: _fn
                times[variant] = chip_smoke.graph_ms(call)
        finally:
            ops._library = real
        times["kernel again"] = chip_smoke.graph_ms(call)
        print(f"[ablation] {name} edge_relax: " + json.dumps(times),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
