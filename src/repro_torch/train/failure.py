"""Fault tolerance: preemption handling, the restartable loop and a
straggler monitor, the port's copy of ``repro.train.failure``.

* :class:`PreemptionHandler`: SIGTERM/SIGINT sets a flag; the training
  loop checkpoints and stops at the next step boundary.
* :func:`run_restartable`: drives a train step with periodic checkpoints
  and a deterministic data fast-forward: the data streams are keyed by
  ``(seed, step)``, so resuming at step k replays the exact batch k
  would have seen.
* :class:`StragglerMonitor`: records per-step wall times and flags steps
  slower than ``threshold`` x the trailing median.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional

import numpy as np

from . import checkpoint as ckpt


class PreemptionHandler:
    """While open, the ``signals`` set ``requested`` instead of their
    handlers running; the old handlers come back on exit.  Signal
    handlers can only be set from the main thread."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._old = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.times = []
        self.window = window
        self.threshold = threshold
        self.flagged = []

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = float(np.median(hist))
        if len(hist) >= 8 and dt > self.threshold * med:
            self.flagged.append((step, dt, med))
            return True
        return False


def run_restartable(step_fn: Callable, make_batch: Callable, state: tuple,
                    *, n_steps: int, ckpt_dir: str, ckpt_every: int = 50,
                    start_step: Optional[int] = None,
                    monitor: Optional[StragglerMonitor] = None,
                    log_every: int = 10, log_fn=print):
    """Drive ``params, opt_state, metrics = step_fn(params, opt_state,
    batch)`` with checkpoints and restart.

    ``state`` is ``(params, opt_state)``, the restore target when a
    checkpoint exists; ``make_batch(step)`` must be deterministic in
    ``step``.  A checkpoint is written every ``ckpt_every`` steps and at
    a preemption.  Returns ``(state, last_step, preempted)``.
    """
    params, opt_state = state
    step0 = start_step if start_step is not None else \
        (ckpt.latest_step(ckpt_dir) or 0)
    if step0 and start_step is None:
        (params, opt_state), _ = ckpt.restore(
            ckpt_dir, step0, target_tree=(params, opt_state))
        log_fn(f"[restore] resumed from step {step0}")
    preempted = False
    step = step0 - 1
    with PreemptionHandler() as pre:
        for step in range(step0, n_steps):
            t0 = time.time()
            batch = make_batch(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            dt = time.time() - t0
            if monitor is not None:
                monitor.record(step, dt)
            if log_every and (step % log_every == 0):
                loss = float(metrics.get("loss", float("nan")))
                log_fn(f"[train] step={step} loss={loss:.4f} "
                       f"dt={dt * 1e3:.0f}ms")
            if ckpt_every and (step + 1) % ckpt_every == 0:
                ckpt.save(ckpt_dir, step + 1, (params, opt_state))
            if pre.requested:
                ckpt.save(ckpt_dir, step + 1, (params, opt_state))
                preempted = True
                log_fn(f"[preempt] checkpointed at step {step + 1}")
                break
    return (params, opt_state), step + 1, preempted
