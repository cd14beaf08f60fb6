"""Trace-driven cost model for the auto-tuner (a copy of
``repro.tune.objective``: pure Python, no tensors).

One traced solve (``EngineConfig(trace=True)`` → ``SolveResult.trace``)
carries everything the tuner needs: per-round counter deltas whose sums
reproduce the final ``SsspMetrics`` exactly (the PR-7 parity contract).
The objective is a weighted sum over those counter sums:

* ``rounds`` — synchronized relaxation rounds (the latency driver on a
  device: one dispatch/sync barrier each);
* ``steps`` — step transitions (each costs the Function 1/2 statistics
  pass);
* ``invocations`` — kernel launches on the blocked/fused paths (weighted
  highest: launch overhead dominates small rounds);
* ``tiles`` — tiles scanned by the compacted blocked schedule (the DMA /
  compute volume);
* ``waste`` — relaxations that did not improve a distance
  (``n_relax - n_updates``; wide windows burn edge bandwidth here).

On ``segment_min`` engines the tile/invocation columns are zero and the
objective gracefully reduces to rounds + steps + waste.  Weights are a
frozen dataclass so a caller (or a future meta-tuner) can re-balance
them without touching the search.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["ObjectiveWeights", "DEFAULT_WEIGHTS", "objective_from_counters",
           "trace_objective"]


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    rounds: float = 1.0
    steps: float = 0.5
    invocations: float = 4.0
    tiles: float = 1e-2
    waste: float = 1e-3


DEFAULT_WEIGHTS = ObjectiveWeights()


def objective_from_counters(c: Mapping,
                            weights: ObjectiveWeights = DEFAULT_WEIGHTS
                            ) -> float:
    """Scalar cost from a counter mapping (``SolveTrace.counter_sums()``
    or ``repro_torch.core.sssp.metrics_dict``).  Missing keys count as zero so
    both shapes (and partial dicts in tests) are accepted."""
    waste = max(float(c.get("n_relax", 0)) - float(c.get("n_updates", 0)),
                0.0)
    return (weights.rounds * float(c.get("n_rounds", 0))
            + weights.steps * float(c.get("n_steps", 0))
            + weights.invocations * float(c.get("n_invocations", 0.0))
            + weights.tiles * float(c.get("n_tiles_scanned", 0.0))
            + weights.waste * waste)


def trace_objective(trace, weights: ObjectiveWeights = DEFAULT_WEIGHTS
                    ) -> float:
    """Cost of one traced solve (a :class:`~repro_torch.obs.trace.SolveTrace`).

    Uses the trace's exact counter sums; a ring that overflowed lost its
    oldest records, so callers should size ``trace_capacity`` above the
    solve's round count (the tuner does).
    """
    return objective_from_counters(trace.counter_sums(), weights)
