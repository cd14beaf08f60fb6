"""``relax_call_pct.batch``: ``relax_call_pct`` in the batched cells, which report
``sssp_gteps.batch``; read as ``relax_call_pct.py`` reads it."""
from bench.metrics.relax_call_pct import read  # noqa: F401
