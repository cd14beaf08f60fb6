"""Budgeted EngineConfig search: coordinate descent + random restarts
(port of ``repro.tune.search``).

:func:`tune` searches the perf-relevant :class:`EngineConfig` axes
(``alpha``/``beta``/``policy``/``fused_rounds``/blocked geometry/
``compact_capacity``) for one graph, scoring each candidate by the trace
objective (:mod:`repro_torch.tune.objective`) of a few traced solves
through the port's :class:`~repro_torch.api.Solver` on ``device``
(default ``cuda``; ``"cpu"`` runs the kernels' plain versions).

Correctness gate: a candidate is accepted **only** when its dist/parent
arrays are *bitwise identical* to the incumbent baseline's on every
probe source.  Windows are pure scheduling, so every valid candidate
should pass; the gate records anything that does not as a
``parity_reject`` instead of shipping it.

Determinism: the only randomness is a seeded ``numpy`` Generator (probe
sources + restart proposals); the trajectory is a pure function of
``(graph, base config, seed, budget, space)`` and equals the
reference's wherever the objective's counters do.  A base on the
sharded tier tunes through the port's sharded tier: every evaluation is
then SPMD, so every rank of the process group calls :func:`tune` with
the same arguments (at world size 1, the one process).

The trajectory goes through the observability plane: per-candidate
counters and a gauge on a ``MetricsRegistry`` and, with ``jsonl_path=``,
one ``tuner_candidate`` JSONL line per evaluation plus a final snapshot
line.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np

from ..core.config import ConfigError, EngineConfig
from ..serve.queries import _host
from .objective import DEFAULT_WEIGHTS, ObjectiveWeights, trace_objective
from .store import TUNED_FIELDS, TunedStore

__all__ = ["TuneResult", "tune", "default_space"]

# generous default ring: probe solves must not overflow the trace ring or
# the objective under-counts early rounds
_TRACE_CAP = 4096

_BLOCKED_SINGLE = ("blocked", "blocked_pallas")


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one :func:`tune` run (see fields; ``trajectory`` holds
    one dict per evaluated candidate, in evaluation order)."""
    gid: str
    best_config: EngineConfig
    best_objective: float
    baseline_objective: float
    n_evals: int
    n_accepted: int
    n_parity_rejects: int
    n_invalid: int
    seed: int
    trajectory: tuple

    @property
    def improved(self) -> bool:
        return self.best_objective < self.baseline_objective

    @property
    def reduction(self) -> float:
        """Fractional objective reduction vs the default config."""
        if self.baseline_objective <= 0:
            return 0.0
        return 1.0 - self.best_objective / self.baseline_objective


def default_space(base: EngineConfig, n: int, goal: str = "tree") -> dict:
    """The searched axes for ``base`` on an ``n``-vertex graph.

    Axes that the base engine cannot carry (blocked geometry on a
    segment_min engine, ``compact_capacity`` off v3) are omitted up
    front; individual invalid combinations that survive are caught per
    candidate and counted as ``invalid``.

    ``goal="p2p"`` adds the goal-directed axes —
    ``use_alt``/``n_landmarks``/``p2p_mode`` — which only move p2p
    probes (ALT bounds need a target, so a tree objective cannot score
    them).  Invalid combinations the sweep proposes (bidirectional
    without ALT or off the static policy, bidirectional on a sharded
    tier) are rejected by config validation and counted as ``invalid``.
    """
    space = {
        "alpha": (1.5, 3.0, 6.0, 12.0),
        "beta": (0.5, 0.7, 0.9, 0.99),
        "policy": ("static", "adaptive"),
    }
    blocked_single = base.backend in _BLOCKED_SINGLE
    sharded = base.tier == "sharded"
    blocked_shard = sharded and base.effective_shard_backend == "blocked"
    if blocked_single or blocked_shard or sharded:
        space["fused_rounds"] = (0, 2, 4, 8)
    if blocked_single or blocked_shard:
        space["block_v"] = (None, max(64, min(256, n // 4)))
        space["tile_e"] = (None, 128, 512)
    if sharded and base.shard_version == "v3":
        space["compact_capacity"] = (0, 32, 128)
    if goal == "p2p":
        space["use_alt"] = (False, True)
        space["n_landmarks"] = (4, 8, 16)
        if not sharded:
            space["p2p_mode"] = ("unidirectional", "bidirectional")
    return space


def _reusable(config: EngineConfig, layout):
    """``layout`` if a session of ``config`` can run on it (a blocked
    backend, and ``block_v``/``tile_e`` unset or the layout's own), else
    None (the session builds its own)."""
    if layout is None or config.backend not in _BLOCKED_SINGLE \
            or config.tier == "sharded":
        return None
    if config.block_v not in (None, layout.block_v) \
            or config.tile_e not in (None, layout.tile_e):
        return None
    return layout


def _evaluate(graph, config: EngineConfig, sources,
              weights: ObjectiveWeights, trace_capacity: int, *,
              device=None, layout=None):
    """Score ``config``: one traced tree solve per probe source.

    Returns ``(dist, parent, objective)`` with dist/parent stacked
    ``[S, n]`` host arrays for the parity gate.  Module-level so tests
    can monkeypatch a deliberately-broken evaluator.
    """
    from ..api import SolveSpec, Solver

    cfg = dataclasses.replace(config, trace=True,
                              trace_capacity=trace_capacity)
    dists, parents, obj = [], [], 0.0
    with Solver.open(graph, cfg, device=device,
                     layout=_reusable(cfg, layout)) as s:
        for src in sources:
            res = s.solve(SolveSpec.tree(int(src)))
            dists.append(_host(res.dist))
            parents.append(_host(res.parent))
            obj += trace_objective(res.trace, weights)
    return np.stack(dists), np.stack(parents), obj


def _evaluate_p2p(graph, config: EngineConfig, pairs, *, device=None,
                  layout=None):
    """Score ``config`` on p2p probe pairs by the engine's own counters.

    The trace plane stays off (``p2p_mode="bidirectional"`` forbids it),
    so the objective is the raw work proxy ``n_rounds + n_relax`` summed
    over the pairs.  Returns ``(distances [P], paths, objective)`` —
    the p2p *contract* surface: ALT pruning deliberately leaves
    off-path dist entries tentative, so full-array parity would reject
    every pruned candidate; d(s, t) and the reconstructed path are what
    must stay bitwise-stable.  Module-level so tests can monkeypatch.
    """
    from ..api import SolveSpec, Solver

    dists, paths, cost = [], [], 0.0
    with Solver.open(graph, config, device=device,
                     layout=_reusable(config, layout)) as s:
        for src, tgt in pairs:
            res = s.solve(SolveSpec.p2p(int(src), int(tgt)))
            dists.append(np.float32(res.distance()))
            paths.append(res.paths())
            m = res.metrics
            cost += float(m.n_rounds) + float(m.n_relax)
    return np.asarray(dists), paths, cost


def _probe_sources(graph, n_sources: int, rng) -> list:
    """Deterministic probe set: the max-degree vertex (the hard solve)
    plus seeded uniform picks."""
    deg = _host(graph.deg)
    n = deg.shape[0]
    srcs = [int(np.argmax(deg))]
    while len(srcs) < min(n_sources, n):
        c = int(rng.integers(0, n))
        if c not in srcs:
            srcs.append(c)
    return srcs


def tune(graph, base: Optional[EngineConfig] = None, *, gid: str = "default",
         budget: int = 24, seed: int = 0, restarts: int = 1,
         n_sources: int = 3, sources=None, goal: str = "tree",
         weights: ObjectiveWeights = DEFAULT_WEIGHTS,
         space: Optional[dict] = None, store: Optional[TunedStore] = None,
         metrics=None, jsonl_path=None,
         trace_capacity: int = _TRACE_CAP, device=None,
         layout=None) -> TuneResult:
    """Search the config space for ``graph`` within ``budget`` candidate
    evaluations (baseline included); returns the :class:`TuneResult`.

    Coordinate descent over :func:`default_space` (or ``space``), with
    ``restarts`` seeded random proposals when a sweep stops improving.
    Every accepted candidate is bitwise dist/parent-identical to the
    baseline.  With ``store=``, the winner is persisted under ``gid``
    (even when it ties the default: the entry records the tune
    happened).  ``metrics``/``jsonl_path`` export the trajectory through
    the observability plane.

    ``goal="p2p"`` tunes for point-to-point traffic instead: probes are
    seeded (source, target) pairs scored by engine counters
    (:func:`_evaluate_p2p`), the space gains the goal-directed
    ``use_alt``/``n_landmarks``/``p2p_mode`` axes, and the parity gate
    is the p2p contract — d(s, t) bitwise + the identical reconstructed
    path (ALT pruning leaves off-path entries tentative by design).

    ``device`` places every evaluation's session (default ``cuda``).
    ``layout`` is a prebuilt blocked layout of ``graph`` on that device,
    which every candidate whose geometry (``block_v``/``tile_e``) is
    unset or the layout's own solves on instead of building one (a
    layout build costs seconds at a million vertices; the solves are
    the same).
    """
    if goal not in ("tree", "p2p"):
        raise ValueError(f"tune goal must be 'tree' or 'p2p', got {goal!r}")
    base = base if base is not None else EngineConfig()
    n = int(graph.deg.shape[0])
    space = (dict(space) if space is not None
             else default_space(base, n, goal))
    rng = np.random.default_rng(seed)
    srcs = (list(map(int, sources)) if sources is not None
            else _probe_sources(graph, n_sources, rng))
    if goal == "p2p":
        tgts = []
        for s_ in srcs:
            t_ = int(rng.integers(0, n))
            while n > 1 and t_ == s_:
                t_ = int(rng.integers(0, n))
            tgts.append(t_)
        pairs = list(zip(srcs, tgts))

        def evaluate(cfg):
            return _evaluate_p2p(graph, cfg, pairs, device=device,
                                 layout=layout)
    else:
        def evaluate(cfg):
            return _evaluate(graph, cfg, srcs, weights, trace_capacity,
                             device=device, layout=layout)

    if metrics is None:
        from ..obs.metrics import MetricsRegistry
        metrics = MetricsRegistry()
    c_cand = metrics.counter("sssp_tuner_candidates_total",
                             "Tuner candidate configs evaluated")
    c_acc = metrics.counter("sssp_tuner_accepted_total",
                            "Tuner candidates accepted as the new best")
    c_par = metrics.counter("sssp_tuner_parity_rejects_total",
                            "Tuner candidates rejected for dist/parent "
                            "parity mismatch")
    c_inv = metrics.counter("sssp_tuner_invalid_total",
                            "Tuner candidates rejected as invalid configs")
    g_best = metrics.gauge("sssp_tuner_best_objective",
                           "Best trace objective so far",
                           labels={"gid": gid})

    trajectory = []
    # trajectory rows show the overlay fields plus every searched axis
    # (the p2p goal-directed axes are searched but not overlaid)
    log_fields = tuple(dict.fromkeys(TUNED_FIELDS + tuple(space)))

    def log_row(row):
        trajectory.append(row)
        if jsonl_path:
            with open(jsonl_path, "a") as f:
                f.write(json.dumps({"kind": "tuner_candidate", "gid": gid,
                                    "seed": seed, "ts": time.time(), **row})
                        + "\n")

    # baseline = incumbent: its dist/parent (p2p: distances/paths) are
    # the parity reference
    ref_dist, ref_parent, base_obj = evaluate(base)
    c_cand.inc()
    g_best.set(base_obj)
    n_evals, n_par, n_inv = 1, 0, 0
    best, best_obj = base, base_obj
    log_row({"eval": 0, "origin": "baseline", "objective": base_obj,
             "accepted": True, "parity": True,
             "config": {f: getattr(base, f) for f in log_fields}})

    def try_candidate(cand: EngineConfig, origin: str) -> bool:
        """Evaluate one candidate; returns whether it became the best."""
        nonlocal n_evals, n_par, n_inv, best, best_obj
        try:
            cand.resolve(n=n, m=int(graph.m))
        except ConfigError:
            n_inv += 1
            c_inv.inc()
            return False
        d, p, obj = evaluate(cand)
        n_evals += 1
        c_cand.inc()
        parity = (np.array_equal(d, ref_dist)
                  and (p == ref_parent if goal == "p2p"
                       else np.array_equal(p, ref_parent)))
        accepted = parity and obj < best_obj - 1e-9
        if not parity:
            n_par += 1
            c_par.inc()
        if accepted:
            best, best_obj = cand, obj
            c_acc.inc()
            g_best.set(best_obj)
        log_row({"eval": n_evals - 1, "origin": origin, "objective": obj,
                 "accepted": accepted, "parity": parity,
                 "config": {f: getattr(cand, f) for f in log_fields}})
        return accepted

    def replace_valid(cfg, **kw):
        try:
            return dataclasses.replace(cfg, **kw)
        except ConfigError:
            return None

    for round_ in range(restarts + 1):
        if round_ > 0:
            if n_evals >= budget:
                break
            # random restart: one seeded proposal over every axis at once
            kw = {dim: vals[int(rng.integers(0, len(vals)))]
                  for dim, vals in space.items()}
            cand = replace_valid(best, **kw)
            if cand is None or cand == best:
                n_inv += 1
                c_inv.inc()
            else:
                try_candidate(cand, f"restart{round_}")
        improved = True
        while improved and n_evals < budget:
            improved = False
            for dim, values in space.items():
                for v in values:
                    if n_evals >= budget:
                        break
                    if v == getattr(best, dim):
                        continue
                    cand = replace_valid(best, **{dim: v})
                    if cand is None:
                        n_inv += 1
                        c_inv.inc()
                        continue
                    if try_candidate(cand, f"descent/{dim}"):
                        improved = True

    result = TuneResult(
        gid=gid, best_config=best, best_objective=best_obj,
        baseline_objective=base_obj, n_evals=n_evals,
        n_accepted=sum(1 for r in trajectory[1:] if r["accepted"]),
        n_parity_rejects=n_par, n_invalid=n_inv, seed=seed,
        trajectory=tuple(trajectory))
    if store is not None:
        meta = {"seed": seed, "n_evals": n_evals, "sources": srcs,
                "goal": goal}
        if goal == "p2p":
            meta["targets"] = tgts
        store.put(gid, graph, best, objective=best_obj, baseline=base_obj,
                  meta=meta)
    if jsonl_path:
        from ..obs.export import write_jsonl_snapshot
        write_jsonl_snapshot(metrics.snapshot(), jsonl_path,
                             meta={"kind": "tuner_summary", "gid": gid,
                                   "seed": seed, "best": best_obj,
                                   "baseline": base_obj,
                                   "n_evals": n_evals})
    return result
