"""Serving example: batched prefill + decode with a KV cache, on the
card.

    PYTHONPATH=src python examples/torch/serve_lm.py [--batch 4] [--gen 32] \\
        [--device cuda|cpu]

The same flow and lines as ``examples/serve_lm.py``, on ``--device``
(default ``cuda``, where attention runs the flash-attention kernel;
without a card that fails, ``--device cpu`` runs the plain attention).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import torch  # noqa: E402

from repro_torch.core.sssp import resolve_device  # noqa: E402
from repro_torch.data.synthetic import LMTokenStream  # noqa: E402
from repro_torch.models.transformer import (LMConfig, decode_step,  # noqa: E402
                                            init_params, prefill)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = LMConfig(name="serve-demo", n_layers=4, d_model=256, n_heads=4,
                   n_kv=2, d_ff=1024, vocab=8192, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    stream = LMTokenStream(cfg.vocab, seed=1)
    prompts = torch.from_numpy(
        stream.batch(0, args.batch, args.prompt_len)).to(device)

    s_cache = args.prompt_len + args.gen
    t0 = time.perf_counter()
    with torch.no_grad():
        cache, logits = prefill(cfg, params, prompts, s_cache)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{t_prefill*1e3:.1f} ms (incl. first call)")

    toks = logits.argmax(-1).to(torch.int32)
    out = [toks]
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(args.gen - 1):
            logits, cache = decode_step(cfg, params, cache, toks)
            toks = logits.argmax(-1).to(torch.int32)
            out.append(toks)
    _sync(device)
    dt = time.perf_counter() - t0
    tps = args.batch * (args.gen - 1) / dt
    print(f"decode: {args.gen - 1} steps x {args.batch} seqs = "
          f"{tps:.0f} tok/s ({device})")
    gen = torch.stack(out, 1)
    print(f"generated shape: {tuple(gen.shape)}; first row: "
          f"{gen[0][:16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
