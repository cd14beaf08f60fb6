"""``host_syncs_per_tree``: the solve loop's reads from the device
(``core/sssp.py::_solve_loop``, ``_run_batch``) per tree of the window: a
batched spec's loop reads once an iteration for all its slots, so each
spec counts its slots' largest ``n_host_syncs``.  Moves ``sssp_gteps``."""


def read(t):
    return t.counters["host_syncs"] / t.trees if t.trees else None
