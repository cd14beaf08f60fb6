"""``device_idle_pct.batch``: ``device_idle_pct`` in the batched cells, which report
``sssp_gteps.batch``; read as ``device_idle_pct.py`` reads it."""
from bench.metrics.device_idle_pct import read  # noqa: F401
