"""``launches_per_tree.batch``: ``launches_per_tree`` in the batched cells, which report
``sssp_gteps.batch``; read as ``launches_per_tree.py`` reads it."""
from bench.metrics.launches_per_tree import read  # noqa: F401
