"""``useful_relax_pct.batch``: ``useful_relax_pct`` in the batched cells, which report
``sssp_gteps.batch``; read as ``useful_relax_pct.py`` reads it."""
from bench.metrics.useful_relax_pct import read  # noqa: F401
