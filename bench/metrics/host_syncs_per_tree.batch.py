"""``host_syncs_per_tree.batch``: ``host_syncs_per_tree`` in the batched cells, which report
``sssp_gteps.batch``; read as ``host_syncs_per_tree.py`` reads it."""
from bench.metrics.host_syncs_per_tree import read  # noqa: F401
