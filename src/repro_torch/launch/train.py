"""Training launcher: the restartable loop over a smoke-size model.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 [--device cpu] [--ckpt-dir DIR] [--ckpt-every 50]

Like the reference launcher it trains the architecture's
``smoke_config()`` (weights drawn from a generator seeded with 0) on the
seeded synthetic stream: ``LMTokenStream`` batches of ``--batch`` x
``--seq`` tokens for an LM, ``RecsysStream`` batches of ``--batch``
users for MIND.  It checkpoints every ``--ckpt-every`` steps into
``--ckpt-dir`` (default: a new temporary directory), resumes from the
latest checkpoint there, checkpoints and stops on SIGTERM or SIGINT, and
fast-forwards the data stream.  Runs on ``cuda`` unless ``--device cpu``
is given; attention is the plain path (the flash kernel has no
backward).  ``chip_smoke.py`` phase 4c trains the full-width models.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from .. import configs
from ..core.sssp import resolve_device
from ..data.synthetic import LMTokenStream, RecsysStream
from ..models import transformer
from ..train import failure, loop as train_loop, optimizer as opt_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    mod = configs.get(args.arch)
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix=f"{args.arch}_ckpt_")
    gen = torch.Generator(device=device).manual_seed(0)

    if mod.FAMILY == "lm":
        cfg = mod.smoke_config()
        opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                      total_steps=args.steps)
        params = transformer.init_params(cfg, gen)
        step = train_loop.make_lm_train_step(cfg, opt_cfg)
        stream = LMTokenStream(cfg.vocab, seed=0)

        def make_batch(i):
            return {"tokens": stream.batch(i, args.batch, args.seq)}
    elif mod.FAMILY == "recsys":
        from ..models.recsys import mind as mind_mod
        cfg = mod.smoke_config()
        opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                      total_steps=args.steps,
                                      master_weights=False)
        params = mind_mod.init_params(cfg, gen)
        step = train_loop.make_mind_train_step(cfg, opt_cfg)
        stream = RecsysStream(cfg.n_items, cfg.hist_len, seed=0)

        def make_batch(i):
            return stream.batch(i, args.batch)
    else:
        raise SystemExit("use examples/gnn_sssp_features.py for GNN training")
    opt_state = opt_mod.adamw_init(params, opt_cfg)

    monitor = failure.StragglerMonitor()
    (_, _), last, pre = failure.run_restartable(
        step, make_batch, (params, opt_state), n_steps=args.steps,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every, monitor=monitor)
    print(f"done: step={last} preempted={pre} ckpt={ckpt_dir} on {device}")


if __name__ == "__main__":
    main()
