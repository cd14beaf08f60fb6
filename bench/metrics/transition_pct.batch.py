"""``transition_pct.batch``: ``transition_pct`` in the batched cells, which report
``sssp_gteps.batch``; read as ``transition_pct.py`` reads it."""
from bench.metrics.transition_pct import read  # noqa: F401
