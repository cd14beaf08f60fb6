"""Serving launcher: continuous-batching engine over a smoke-size model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 8 --max-new 16 [--device cpu]

Runs on ``cuda`` (the flash-attention kernel) unless ``--device cpu`` is
given (the plain attention).  Like the reference launcher it serves the
architecture's ``smoke_config()``, with weights drawn from a generator
seeded with 0; ``chip_smoke.py`` serves the full-width model.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..core.sssp import resolve_device
from ..models import transformer
from ..serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    mod = configs.get(args.arch)
    if mod.FAMILY != "lm":
        raise SystemExit("the serving launcher supports LM archs")
    device = resolve_device(args.device)
    cfg = mod.smoke_config()
    gen = torch.Generator(device=device).manual_seed(0)
    params = transformer.init_params(cfg, gen)
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         s_cache=128, prompt_pad=16)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              rng.integers(4, 32)).astype(np.int32)
        engine.submit(Request(rid=i, prompt=prompt, max_new=args.max_new))
    steps = engine.run()
    dt = time.perf_counter() - t0
    total = args.requests * args.max_new
    print(f"served {args.requests} requests ({total} tokens) in {dt:.1f}s "
          f"over {steps} engine steps on {device} (attention: "
          f"{engine.attn}; {total / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
