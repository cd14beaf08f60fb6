"""``launches_per_tree``: launches of the ``edge_relax`` kernels
(``kernels/edge_relax/ops.py::LAUNCHES``, every entry) per tree of the
window.  Moves ``sssp_gteps``."""


def read(t):
    return t.counters["launches"] / t.trees if t.trees else None
