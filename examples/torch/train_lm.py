"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
with checkpointing, preemption handling, and deterministic restart, on
the card.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 300 \\
        [--params 100m] [--device cuda|cpu]

The default is a ~10M model / 120 steps; pass --params 100m --steps 300
for the full-size run (the model definition and training stack are
identical).  The same flow and lines as ``examples/train_lm.py``, on
``--device`` (default ``cuda``; without a card that fails).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import torch  # noqa: E402

from repro_torch.core.sssp import resolve_device  # noqa: E402
from repro_torch.data.synthetic import LMTokenStream  # noqa: E402
from repro_torch.models.transformer import LMConfig, init_params  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import failure, optimizer as opt_mod  # noqa: E402

SIZES = {
    # ~10M: quick; ~100M: the assignment's end-to-end size
    "10m": dict(n_layers=4, d_model=256, n_heads=4, n_kv=2, d_ff=1024,
                vocab=8192),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv=4, d_ff=2304,
                 vocab=32768),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--params", choices=list(SIZES), default="10m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = LMConfig(name=f"lm-{args.params}", dtype=torch.float32,
                   **SIZES[args.params])
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model})")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt_cfg = opt_mod.AdamWConfig(lr=3e-4, warmup_steps=20,
                                  total_steps=args.steps)
    opt_state = opt_mod.adamw_init(params, opt_cfg)
    step_fn = train_loop.make_lm_train_step(cfg, opt_cfg)
    stream = LMTokenStream(cfg.vocab, seed=0)

    def make_batch(step):
        return {"tokens": torch.from_numpy(
            stream.batch(step, args.batch, args.seq)).to(device)}

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")
    monitor = failure.StragglerMonitor()
    (params, opt_state), last, preempted = failure.run_restartable(
        step_fn, make_batch, (params, opt_state), n_steps=args.steps,
        ckpt_dir=ckpt_dir, ckpt_every=50, monitor=monitor)
    print(f"finished at step {last} (preempted={preempted}); "
          f"checkpoints in {ckpt_dir}")
    if monitor.flagged:
        print(f"straggler steps flagged: {monitor.flagged[:5]}")
    return last


if __name__ == "__main__":
    main()
