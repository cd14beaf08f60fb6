"""Offline per-graph auto-tuning (port of ``repro.tune``).

``tune/objective.py`` turns one traced solve into a scalar cost,
``tune/search.py`` runs a budgeted, parity-validated search over the
:class:`~repro_torch.core.config.EngineConfig` space, and
``tune/store.py`` persists winners in a :class:`TunedStore` keyed by gid
+ graph fingerprint (the reference's file format), consulted by the
serving registry and ``Solver.open`` through their ``tuned=``.
"""
from .objective import (DEFAULT_WEIGHTS, ObjectiveWeights,
                        objective_from_counters, trace_objective)
from .search import TuneResult, tune
from .store import TUNED_FIELDS, TunedStore, graph_fingerprint

__all__ = [
    "ObjectiveWeights", "DEFAULT_WEIGHTS", "objective_from_counters",
    "trace_objective", "tune", "TuneResult", "TunedStore",
    "graph_fingerprint", "TUNED_FIELDS",
]
