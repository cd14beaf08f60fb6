"""``relax_roofline_pct.batch``: ``relax_roofline_pct`` in the batched cells, which report
``sssp_gteps.batch``; read as ``relax_roofline_pct.py`` reads it."""
from bench.metrics.relax_roofline_pct import read  # noqa: F401
