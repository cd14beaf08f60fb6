"""``chip_smoke.py``'s phase 3f alone: the tuner and the routed serving
tier on kronecker(20,16), without the rest of the smoke.

    python3 tools/serving_phase.py

Builds the kernels, generates ``kronecker(**chip_smoke.KRON)``, builds its
blocked layout on the card and solves the tree from the max-degree source
(twice: the first call makes the kernels' scratch), then runs
``chip_smoke.serving_phase`` on it: the same ``[tune]``, ``[serving]`` and
``[profile]`` lines and checks as in the smoke (about 2 minutes on an
H100, of which about 40 s generate the graph).  Prints the card's name
and power limit first and the phase's numbers as one JSON line last.
Needs one card; for iterating on the serving plane, whose numbers the
full smoke takes about 15 minutes to reach.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("serving_phase: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core.graph import build_blocked
    from repro_torch.core.sssp import sssp
    from repro_torch.data.generators import kronecker
    from repro_torch.kernels import _build
    device = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    hg = kronecker(**cs.KRON)
    dg = hg.to_device(device)
    bg = build_blocked(dg)
    source = int(np.argmax(hg.deg))
    for _ in range(2):
        dist, parent, _ = sssp(dg, source, backend="blocked", layout=bg,
                               device=device)
    cs.log(f"[setup] build, graph, layout and tree solve in "
           f"{time.perf_counter() - t0:.1f} s")
    res = dict(host=hg, graph=dg, layout=bg, source=source, dist=dist,
               parent=parent)
    t0 = time.perf_counter()
    out = cs.serving_phase({"kronecker(20,16)": res}, device)
    cs.log(f"[time] phase 3f: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
