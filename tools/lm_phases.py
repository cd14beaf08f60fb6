"""``chip_smoke.py``'s phases 4b and 4c alone: the four other LMs served
at full width and the training phase, without the rest of the smoke.

    python3 tools/lm_phases.py

Builds the kernels, then runs ``chip_smoke.lm_configs_phase`` (the
flash kernel at the new shapes, ``moe_block`` card against CPU, four
models served twice) and ``chip_smoke.training_phase`` (qwen3-0.6b
training at full width, a train step card against CPU, MIND training,
the preempted and resumed loop): the same ``[flash_attention]``,
``[moe]``, ``[lm]``, ``[serve4b]`` and ``[train]`` lines and checks as
in the smoke (about 2 minutes on an H100).  Prints the card's name and
power limit first and the phases' numbers as one JSON line last.  Needs
one card.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_phases: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    device = torch.device("cuda")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[setup] build in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served = cs.lm_configs_phase(device)
    cs.log(f"[time] phase 4b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training = cs.training_phase(device)
    cs.log(f"[time] phase 4c: {time.perf_counter() - t0:.1f} s")
    for m in served["served"].values():
        m.pop("tokens", None)
    print(json.dumps({"lm_configs": served, "training": training},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
